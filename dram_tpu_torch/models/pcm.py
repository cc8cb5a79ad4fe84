"""PCM: the pixel-correlation refinement as masked stencil attention.

Port of dram_tpu/models/pcm.py:145-358: each voxel attends to its k^3-stencil neighbours (stencil_offsets, any
k_size, connectivity and self loop) with a validity mask at the volume's
faces,

    w_ij  = merge(theta(f_i) . phi(f_j), deg_i)   over valid j in stencil(i)
    cam'_i = r( sum_j w_ij * G(cam_j) )

`non_local_iter` times, with or without the residual. Dispatch is
dram_tpu's (:231-233): the merge type 'scaled_dot_product_relu' without
positional encoding (p_enc_dim = 0) runs the stencil-attention kernels
(window_attention.stencil_attention, differentiable, whatever the
stencil and widths); every other merge type, and any PCM with
p_enc_dim > 0, runs the plain torch formulation below, which is
dram_tpu's XLA path (per-offset rolls of the edge statistics, then
merge_weights' 13 merge types), on the card as on the CPU. dram_tpu's
semantics are kept where they are odd: heu1's mask carries no gradient
(stop_gradient), 'cosine' divides by the raw, possibly negative sum, and
an all-invalid row's softmax maximum is pinned to 0.

f_dim = 0 and g_dim = 0 drop the theta/phi and G/r dense layers (identity
projections); geo_f_dim > 0 adds the geo_theta / geo_phi layers on the
positional encoding. The dense layers run in f32 where dram_tpu runs them
in the compute dtype.

A block of a larger volume passes `z0` (the global index of its z = 0)
and `z_extent` (the volume's depth): validity and the positional
encoding follow global z, and such a block takes the plain path, as in
dram_tpu (:231-233). `pcm_sharded` (:312-358) runs the PCM context
parallel over the ranks of a process group: the D axis padded to the
world and split, one halo of f and one of cam per iteration.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.mesh import all_gather_cat, halo_exchange, rank, world_size
from ..kernels import window_attention
from ..kernels.window_attention import _shift, stencil_offsets, valid_masks

MERGE_TYPES = ("l2", "sm", "l2sm", "scaled_dot_product",
               "scaled_dot_product_relu", "scaled_dot_product_geo",
               "scaled_dot_product_geo_relu", "att_is_all", "smscaled",
               "l2smrelu", "cosine", "smrelu", "heu1", "heu2")


def build_geo_feature(spatial_size, p_enc_dim, device=None, z0=0):
    """Sin/cos 3-D positional encoding, channels last (D, H, W,
    p_enc_dim), f32: dram_tpu/models/pcm.py:build_geo_feature_z0 (at
    z0 = 0 equal to build_geo_feature, :53); local z index i encodes
    position z0 + i. The channel range
    [d * d_model, (d + 1) * d_model) encodes axis d, even channels sin,
    odd channels cos, frequencies 1e-4^(2j / d_model)."""
    nd = len(spatial_size)
    if p_enc_dim % (2 * nd) != 0:
        raise ValueError(f"p_enc_dim ({p_enc_dim}) must be divisible by "
                         f"{2 * nd}")
    d_model = p_enc_dim // nd
    div = torch.from_numpy(np.power(
        1e-4, np.arange(0, d_model, 2) / d_model).astype(np.float32))
    div = div.to(device)
    parts = []
    for d in range(nd):
        shape = [1] * nd
        shape[d] = spatial_size[d]
        grid = torch.arange(spatial_size[d], dtype=torch.float32,
                            device=device)
        if d == 0:
            grid = grid + float(z0)
        grid = grid.reshape(shape)
        arg = grid.expand(*spatial_size)[..., None] * div
        sc = torch.stack([torch.sin(arg), torch.cos(arg)], dim=-1)
        parts.append(sc.reshape(*spatial_size, d_model))
    return torch.cat(parts, dim=-1)


def _masked_softmax(logits, valid):
    """Softmax over the valid entries of the last axis; an all-invalid
    row's maximum is pinned to 0, so the row comes out exactly 0."""
    logits = torch.where(valid > 0, logits,
                         torch.full_like(logits, float("-inf")))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(logits - m) * valid
    return e / torch.clamp(e.sum(-1, keepdim=True), min=1e-12)


def _l2_normalize(x, valid, eps=1e-12):
    x = x * valid
    n = torch.sqrt((x * x).sum(-1, keepdim=True))
    return x / torch.clamp(n, min=eps)


def merge_weights(mt, acc, valid, deg):
    """Edge accumulators -> attention weights (..., K): dram_tpu's
    PCM.merge_weights (:170-211) for merge type `mt`."""
    sqrt_deg = torch.sqrt(torch.clamp(deg, min=1.0))[..., None]
    relu = torch.relu
    if mt == "l2":
        w = torch.exp(-5.0 * acc["l2"]) * valid
        return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    if mt == "sm":
        return _masked_softmax(acc["dot"], valid)
    if mt == "l2sm":
        return _masked_softmax(_l2_normalize(acc["dot"], valid), valid)
    if mt == "scaled_dot_product":
        return _masked_softmax(acc["dot"] / sqrt_deg, valid)
    if mt == "scaled_dot_product_relu":
        return _masked_softmax(relu(acc["dot"]) / sqrt_deg, valid)
    if mt == "scaled_dot_product_geo":
        return _masked_softmax((acc["dot"] + acc["geodot"]) / sqrt_deg,
                               valid)
    if mt == "scaled_dot_product_geo_relu":
        return _masked_softmax(
            (relu(acc["dot"]) + acc["geodot"]) / sqrt_deg, valid)
    if mt == "att_is_all":
        return _masked_softmax(acc["sumdot"] / sqrt_deg, valid)
    if mt == "smscaled":
        return _masked_softmax(acc["dot"] / 0.01, valid)
    if mt == "l2smrelu":
        return _masked_softmax(_l2_normalize(relu(acc["dot"]), valid),
                               valid)
    if mt == "cosine":
        # the reference normalizes by the raw (possibly negative) sum
        w = acc["cos"] * valid
        return w / w.sum(-1, keepdim=True)
    if mt == "smrelu":
        return _masked_softmax(relu(acc["dot"]), valid)
    if mt == "heu1":
        f = acc["dot"] / (1.0 + acc["absdiff"])
        f = f * (f >= 0.03).to(f.dtype).detach() * valid
        return f / (1e-7 + f.sum(-1, keepdim=True))
    if mt == "heu2":
        f = relu(acc["dot"] / (1.0 + acc["absdiff"])) * valid
        return f / (1e-7 + f.sum(-1, keepdim=True))
    raise NotImplementedError(f"merge type {mt}")


class PCM(nn.Module):
    """The PCM of dram_tpu; forward(cam (B, D, H, W, g_ch), f (B, D, H, W,
    in_ch)) -> refined cam, f32. The defaults are the shipped
    configuration's (dram_tpu's module defaults are merge type 'l2',
    self loop, p_enc_dim 32; DC3DATGeneric passes every value)."""

    def __init__(self, in_ch=17, g_ch=1, f_dim=8, geo_f_dim=0, g_dim=8,
                 non_local_iter=1, k_size=3,
                 merge_type="scaled_dot_product_relu", self_loop=False,
                 connectivity=2, residual=False, p_enc_dim=0):
        super().__init__()
        if merge_type not in MERGE_TYPES:
            raise NotImplementedError(f"merge type {merge_type}")
        self.offsets = stencil_offsets(k_size, connectivity, self_loop)
        self.merge_type = merge_type
        self.non_local_iter = non_local_iter
        self.residual = residual
        self.p_enc_dim = p_enc_dim
        if f_dim > 0:
            self.theta = nn.Linear(in_ch, f_dim)
            self.phi = nn.Linear(in_ch, f_dim)
        if p_enc_dim > 0 and geo_f_dim > 0:
            self.geo_theta = nn.Linear(p_enc_dim, geo_f_dim)
            self.geo_phi = nn.Linear(p_enc_dim, geo_f_dim)
        if g_dim > 0:
            self.G = nn.Linear(g_ch, g_dim)
            self.r = nn.Linear(g_dim, g_ch)

    @property
    def uses_kernel(self):
        """The dispatch of dram_tpu (:231-233): the stencil-attention kernel
        takes this PCM."""
        return self.merge_type == "scaled_dot_product_relu" \
            and self.p_enc_dim == 0

    def _proj(self, name, x):
        layer = getattr(self, name, None)
        return layer(x) if layer is not None else x

    def _iterate(self, cam, attend, iters):
        for _ in range(self.non_local_iter if iters is None else iters):
            out = attend(self._proj("G", cam))
            refined = self._proj("r", out)
            cam = refined + cam if self.residual else refined
        return cam

    def forward(self, cam, f, z0=0, z_extent=None, iters=None):
        """`z0` / `z_extent` place the block in a larger volume (global
        z decides validity and the encoding); `iters` overrides
        non_local_iter (pcm_sharded runs one at a time)."""
        # f32 (float64 inputs keep float64 on the plain path: the tests'
        # reference precision for the ill-conditioned merge types)
        dt = torch.float64 if f.dtype == torch.float64 else torch.float32
        cam, f = cam.to(dt), f.to(dt)
        theta = self._proj("theta", f)
        phi = self._proj("phi", f)
        if self.uses_kernel and z0 == 0 and z_extent is None:
            theta, phi = theta.contiguous(), phi.contiguous()
            return self._iterate(cam, lambda g: window_attention
                                 .stencil_attention(theta, phi,
                                                    g.contiguous(),
                                                    self.offsets), iters)
        w = self.edge_weights(theta, phi, z0, z_extent)
        offsets = self.offsets

        def attend(g):
            out = 0.0
            for k, off in enumerate(offsets):
                out = out + w[..., k:k + 1] * _shift(g, off)
            return out
        return self._iterate(cam, attend, iters)

    def edge_weights(self, theta, phi, z0=0, z_extent=None):
        """The plain path's attention weights (B, D, H, W, K) from the
        per-offset edge statistics (dram_tpu :263-296)."""
        spatial = tuple(theta.shape[1:4])
        offsets = self.offsets
        valid = valid_masks(spatial, offsets, theta.device, z0,
                            z_extent).to(theta.dtype)
        deg = valid.sum(-1)
        geo_theta = geo_phi = None
        if self.p_enc_dim > 0:
            geo = build_geo_feature(spatial, self.p_enc_dim,
                                    theta.device, z0).to(theta.dtype)
            geo = geo[None].expand(theta.shape[0], *geo.shape)
            geo_theta = self._proj("geo_theta", geo)
            geo_phi = self._proj("geo_phi", geo)
        mt = self.merge_type
        need_dot = mt in ("sm", "l2sm", "scaled_dot_product",
                          "scaled_dot_product_relu", "scaled_dot_product_geo",
                          "scaled_dot_product_geo_relu", "smscaled",
                          "l2smrelu", "smrelu", "heu1", "heu2")
        need_geo = mt in ("scaled_dot_product_geo",
                          "scaled_dot_product_geo_relu")
        acc = {k: [] for k in ("dot", "geodot", "sumdot", "l2", "cos",
                               "absdiff")}
        for off in offsets:
            phi_j = _shift(phi, off)
            if need_dot:
                acc["dot"].append((theta * phi_j).sum(-1))
            if need_geo or mt == "att_is_all":
                gphi_j = _shift(geo_phi, off)
                if need_geo:
                    acc["geodot"].append((geo_theta * gphi_j).sum(-1))
                else:
                    acc["sumdot"].append(
                        ((theta + geo_theta) * (phi_j + gphi_j)).sum(-1))
            if mt == "l2":
                acc["l2"].append(((theta - phi_j) ** 2).sum(-1))
            if mt == "cosine":
                tn = theta / torch.clamp(
                    torch.linalg.norm(theta, dim=-1, keepdim=True), min=1e-8)
                pn = phi_j / torch.clamp(
                    torch.linalg.norm(phi_j, dim=-1, keepdim=True), min=1e-8)
                acc["cos"].append((tn * pn).sum(-1))
            if mt in ("heu1", "heu2"):
                acc["absdiff"].append((theta - phi_j).abs().sum(-1))
        acc = {k: torch.stack(v, -1) for k, v in acc.items() if v}
        return merge_weights(mt, acc, valid[None], deg[None])


def pcm_sharded(pcm, cam, f, group):
    """Context-parallel PCM (dram_tpu/models/pcm.py:pcm_sharded): every
    rank holds the whole (B, D, H, W, C) `cam` and `f`; D is padded with
    zero planes to a multiple of the world (the pad planes lie at global
    z >= D, which validity excludes, and their outputs are dropped) and
    each rank takes its block, extends f by one halo and cam by one halo
    per iteration (halo_exchange), runs `pcm` with its block's global z
    origin and the volume's depth, and crops. The blocks are gathered:
    every rank returns the whole refined cam. The halo is the largest
    |dz| of the stencil's offsets (k = 5 stencils at connectivity 1 and
    2 are asymmetric)."""
    halo = max(abs(o[0]) for o in pcm.offsets)
    D = cam.shape[1]
    n, r = world_size(group), rank(group)
    d_pad = (-D) % n
    if d_pad:
        widths = (0, 0, 0, 0, 0, 0, 0, d_pad)
        cam = torch.nn.functional.pad(cam, widths)
        f = torch.nn.functional.pad(f, widths)
    d_local = cam.shape[1] // n
    cam_blk = cam[:, r * d_local:(r + 1) * d_local].contiguous()
    f_ext = halo_exchange(f[:, r * d_local:(r + 1) * d_local].contiguous(),
                          halo, 1, group)
    z0 = r * d_local - halo
    out = cam_blk
    for _ in range(pcm.non_local_iter):
        cam_ext = halo_exchange(out, halo, 1, group)
        ref = pcm(cam_ext, f_ext, z0=z0, z_extent=D, iters=1)
        out = ref[:, halo:halo + d_local].contiguous()
    out = all_gather_cat(out, group, dim=1)
    return out[:, :D] if d_pad else out

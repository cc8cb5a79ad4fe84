"""Stencil attention of the PCM refinement (merge type
'scaled_dot_product_relu') and its gradient.

Port of dram_tpu/core/pallas/window_attention.py:stencil_attention, the
jax.custom_vjp that dram_tpu/models/pcm.py calls on its use_pallas
branch: the forward (_fwd_kernel) and the two passes of its backward
(_vjp_bwd: the per-voxel statistics _scal_kernel, then the gathered
gradients _bwd_kernel), bound together by StencilAttentionFunction. CUDA
source: csrc/stencil_attention.cu. The plain versions are the roll+mask
formulation of dram_tpu/models/pcm.py.

The launch geometry of the forward and the gradient pass is decided here
(fwd_plan, bwd_plan): a block owns a tile of (batch element, run of
z-planes, run of rows, run of columns) and streams it along z through a
ring of shared-memory plane buffers, each holding the tile's rows and
columns with a +-1 halo. The plans raise where a tile plan would leave a
voxel uncovered; the C launchers run the `args` vector they are handed
and refuse one whose buffers or coverage differ from the kernel's.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

# threads a block may have (csrc/stencil_attention.cu: FWD_THREADS,
# BWD_THREADS: two for each voxel of the tile's plane, in warps that share
# 16 voxels (forward) or warp pairs that share 32 (gradient pass), and a
# producer warp)
FWD_THREADS, BWD_THREADS = 288, 288
# bytes of one staged voxel: phi, g, theta (forward); phi, g, theta, ybar
# and the four statistics (gradient pass)
FWD_VOXEL, BWD_VOXEL = 3 * 32, 4 * 32 + 16
# the tile the plans take where the grid allows: (planes, rows, columns)
# per tile, forward and gradient pass. On the card (NVIDIA H100 80GB
# HBM3, 700 W; tools/attention_variants.py) 8 rows of 16 columns and 16
# planes a run were within a few percent of the best of 24 tiles of 64 to
# 128 voxels at every attention launch of the flagship: their buffers
# leave room for three forward blocks (two gradient blocks) on an SM.
# Deeper rings than NBUF gained nothing.
FWD_RUNS = BWD_RUNS = (16, 8, 16)
# plane buffers: three read (z - 1, z, z + 1) while a fourth loads
NBUF, MAX_NBUF = 4, 8
# shared memory a block may have; the ring's mbarriers
SMEM_BLOCK, BAR_BYTES = 227 * 1024, 128


@functools.lru_cache(maxsize=8)
def stencil_offsets(k_size=3, connectivity=2, self_loop=False):
    """Neighbour offsets of scipy's generate_binary_structure(3,
    connectivity) (the voxels within L1 distance `connectivity` of the
    centre), minus the centre unless `self_loop`, in lexicographic (z, y,
    x) order: dram_tpu/models/pcm.py:stencil_offsets without scipy."""
    if k_size != 3:
        raise NotImplementedError(
            f"k_size={k_size}: only the shipped k=3 stencil is ported "
            "(ROADMAP Queue 1, PCM variants)")
    offs = []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                l1 = abs(dz) + abs(dy) + abs(dx)
                if l1 <= connectivity and (l1 > 0 or self_loop):
                    offs.append((dz, dy, dx))
    return tuple(offs)


# the offsets csrc/stencil_attention.cu enumerates
KERNEL_OFFSETS = stencil_offsets(3, 2, False)


def valid_masks(spatial, offsets, device=None):
    """(D, H, W, K) bool: neighbour i + offset lies inside the volume
    (dram_tpu/models/pcm.py:_valid_masks with z0 = 0)."""
    D, H, W = spatial
    iz = torch.arange(D, device=device)[:, None, None]
    iy = torch.arange(H, device=device)[None, :, None]
    ix = torch.arange(W, device=device)[None, None, :]
    masks = [(iz + dz >= 0) & (iz + dz < D) & (iy + dy >= 0) & (iy + dy < H)
             & (ix + dx >= 0) & (ix + dx < W) for dz, dy, dx in offsets]
    return torch.stack(masks, dim=-1)


def _shift(x, off):
    """x[i] <- x[i + off] over the spatial axes of (B, D, H, W, C)."""
    return torch.roll(x, shifts=(-off[0], -off[1], -off[2]), dims=(1, 2, 3))


def _edge_logits(theta, phi, offsets):
    """Per offset k the masked logit relu(theta_i . phi_{i+o}) r_i (-inf
    where i + o lies outside), the raw dot and r = 1/sqrt(max(deg, 1)):
    ((B, D, H, W, K), (B, D, H, W, K), (D, H, W, 1))."""
    valid = valid_masks(theta.shape[1:4], offsets, theta.device)
    r = torch.rsqrt(torch.clamp(valid.sum(-1, keepdim=True).float(),
                                min=1.0))
    dots = torch.stack([(theta * _shift(phi, off)).sum(-1)
                        for off in offsets], dim=-1)
    logits = torch.where(valid, torch.relu(dots) * r,
                         torch.tensor(float("-inf"), device=theta.device))
    return logits, dots, r


def stencil_attention_plain(theta, phi, g, offsets=KERNEL_OFFSETS):
    """theta, phi: (B, D, H, W, F); g: (B, D, H, W, G) -> (B, D, H, W, G).

    Per voxel, a softmax over the valid stencil neighbours j of
    relu(theta_i . phi_j) / sqrt(deg_i), aggregating g_j, in f32."""
    theta, phi, g = theta.float(), phi.float(), g.float()
    logits, _, _ = _edge_logits(theta, phi, offsets)
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(logits - m)
    w = e / torch.clamp(e.sum(-1, keepdim=True), min=1e-12)
    out = torch.zeros_like(g)
    for k, off in enumerate(offsets):
        out = out + w[..., k:k + 1] * _shift(g, off)
    return out


def _check_grid(name, offsets, *ts):
    """Raise unless the kernel takes these operands: the 18-offset
    stencil, f32 (B, D, H, W, 8) tensors on one grid, contiguous."""
    if tuple(offsets) != KERNEL_OFFSETS:
        raise ValueError(f"{name}: the kernel implements the k=3, "
                         "connectivity-2, no-self-loop stencil only")
    shape = tuple(ts[0].shape)
    if len(shape) != 5 or shape[-1] != 8 \
            or any(tuple(t.shape) != shape for t in ts):
        raise ValueError(f"{name}: needs F = G = 8 on one grid, got "
                         f"{[tuple(t.shape) for t in ts]}")
    for k, t in enumerate(ts):
        _build.check_operand(t, torch.float32, f"{name} operand {k}")
    return shape[:4]


def _cdiv(a, b):
    return -(-a // b)


def _smem(nbuf, rows, cols, voxel):
    """Dynamic shared memory of a block: the mbarriers' BAR_BYTES, then
    nbuf buffers of rows x cols staged voxels (csrc/stencil_attention.cu:
    smem_bytes)."""
    return BAR_BYTES + nbuf * rows * cols * voxel


def _threads(yr, xr):
    """Threads of a block whose tile plane has yr x xr voxels: two a
    voxel, in whole warp pairs of 32 voxels, and the producer warp."""
    return 64 * _cdiv(yr * xr, 32) + 32


def _plan(B, D, H, W, bwd, runs=None, nbuf=None):
    """The tile plan of one launch (fwd_plan / bwd_plan)."""
    if min(D, H, W) < 1 or B < 0:
        raise ValueError(f"stencil_attention plan: empty grid "
                         f"{(B, D, H, W)}")
    zr, yr, xr = runs or tuple(min(r, n) for r, n in zip(
        BWD_RUNS if bwd else FWD_RUNS, (D, H, W)))
    nbuf = nbuf or NBUF
    tiles = (_cdiv(W, xr), _cdiv(H, yr), _cdiv(D, zr))
    rows, cols = min(yr + 2, H), min(xr + 2, W)
    threads = _threads(yr, xr)
    smem = _smem(nbuf, rows, cols, BWD_VOXEL if bwd else FWD_VOXEL)
    p = {"run": (zr, yr, xr), "tiles": tiles,
         "blocks": B * tiles[0] * tiles[1] * tiles[2], "rows": rows,
         "cols": cols, "nbuf": nbuf, "threads": threads, "smem": smem,
         "args": (zr, yr, xr, *tiles, rows, cols, nbuf, threads, smem)}
    return _check(p, B, D, H, W, bwd)


def _check(p, B, D, H, W, bwd):
    """Raise unless plan `p` covers every voxel once, within its buffers
    and the card's limits."""
    zr, yr, xr = p["run"]
    tx, ty, tz = p["tiles"]
    if tx * xr < W or ty * yr < H or tz * zr < D:
        raise ValueError(f"stencil_attention plan {p['args']} leaves voxels "
                         f"of {(B, D, H, W)} uncovered")
    voxel, most = (BWD_VOXEL, BWD_THREADS) if bwd \
        else (FWD_VOXEL, FWD_THREADS)
    if p["rows"] != min(yr + 2, H) or p["cols"] != min(xr + 2, W) \
            or not 3 <= p["nbuf"] <= MAX_NBUF \
            or p["smem"] != _smem(p["nbuf"], p["rows"], p["cols"], voxel):
        raise ValueError(f"stencil_attention plan {p['args']}: buffers "
                         "differ from the kernel's")
    if p["threads"] != _threads(yr, xr) or p["threads"] > most \
            or p["smem"] > SMEM_BLOCK:
        raise ValueError(f"stencil_attention plan {p['args']}: block too "
                         "large")
    return p


@functools.lru_cache(maxsize=None)
def fwd_plan(B, D, H, W, runs=None, nbuf=None):
    """Geometry of one launch of csrc/stencil_attention.cu's forward on a
    (B, D, H, W) grid: runs (ZR planes, YR rows, XR columns) per tile
    (FWD_RUNS, clipped to the grid, unless `runs` is given), the tile grid
    (x fastest, then y, z, batch element), the staged rows and columns per
    plane buffer (the run and its +-1 halo, clipped), the ring's nbuf
    buffers (NBUF unless given) and the threads: two a voxel of the
    tile's plane, lanes l and l + 16 of a warp, each over nine of the
    offsets, and the producer warp. `args` is the vector the launcher
    runs."""
    return _plan(B, D, H, W, False, runs, nbuf)


@functools.lru_cache(maxsize=None)
def bwd_plan(B, D, H, W, runs=None, nbuf=None):
    """Geometry of one launch of csrc/stencil_attention.cu's gradient pass
    on a (B, D, H, W) grid: as fwd_plan, with BWD_RUNS, the gradient
    pass's staged voxel (phi, g, theta, ybar and the statistics, 144
    bytes) and two threads a voxel in warps of one side each (+o, -o) that
    share 32 voxels."""
    return _plan(B, D, H, W, True, runs, nbuf)


def _args(vals):
    return (ctypes.c_int64 * len(vals))(*vals)


def _forward(theta, phi, g, offsets):
    """The forward: CUDA tensors launch csrc/stencil_attention.cu (else
    raise); CPU tensors take the plain version."""
    if not theta.is_cuda:
        return stencil_attention_plain(theta, phi, g, offsets)
    B, D, H, W = _check_grid("stencil_attention", offsets, theta, phi, g)
    out = torch.empty_like(g)
    if out.numel() == 0:
        return out
    plan = fwd_plan(B, D, H, W)
    _build.launch("stencil_attention_f32", theta.data_ptr(), phi.data_ptr(),
                  g.data_ptr(), out.data_ptr(), B, D, H, W,
                  _args(plan["args"]))
    stencil_attention.launches += 1
    return out


# --- backward -------------------------------------------------------------------


def stencil_attention_scal_plain(theta, phi, g, ybar,
                                 offsets=KERNEL_OFFSETS):
    """Per-voxel statistics of the backward, (B, D, H, W, 4) f32 =
    [r, m, denom, c]: r = 1/sqrt(max(deg, 1)), m = max(0, max_j s_ij) of
    the logits s_ij = relu(theta_i . phi_j) r over the valid neighbours,
    denom = sum_j exp(s_ij - m), c = sum_j a_ij (ybar_i . g_j) with the
    softmax weights a_ij."""
    theta, phi, g, ybar = (t.float() for t in (theta, phi, g, ybar))
    logits, _, r = _edge_logits(theta, phi, offsets)
    m = torch.clamp(logits.amax(dim=-1), min=0.0)
    e = torch.exp(logits - m[..., None])
    denom = e.sum(-1)
    u = torch.stack([(ybar * _shift(g, off)).sum(-1) for off in offsets],
                    dim=-1)
    c = (e * u).sum(-1) / torch.clamp(denom, min=1e-12)
    return torch.stack([r[..., 0].expand_as(m), m, denom, c], dim=-1)


def stencil_attention_scal(theta, phi, g, ybar, offsets=KERNEL_OFFSETS):
    """Kernel wrapper of stencil_attention_scal_plain: CUDA tensors launch
    csrc/stencil_attention.cu's statistics pass (f32, F = G = 8, the
    18-offset stencil, else raise); CPU tensors take the plain version."""
    if not theta.is_cuda:
        return stencil_attention_scal_plain(theta, phi, g, ybar, offsets)
    B, D, H, W = _check_grid("stencil_attention_scal", offsets, theta, phi,
                             g, ybar)
    scal = torch.empty((B, D, H, W, 4), dtype=torch.float32,
                       device=theta.device)
    _build.launch("stencil_attention_scal_f32", theta.data_ptr(),
                  phi.data_ptr(), g.data_ptr(), ybar.data_ptr(),
                  scal.data_ptr(), B, D, H, W)
    stencil_attention_scal.launches += 1
    return scal


stencil_attention_scal.launches = 0


def stencil_attention_bwd_plain(theta, phi, g, ybar, scal,
                                offsets=KERNEL_OFFSETS):
    """(dtheta, dphi, dg) of the stencil attention from its inputs, the
    output cotangent ybar and the statistics `scal` (r, m, denom, c):

        dtheta_j = sum_o ds_o(j) phi_{j+o}
        dphi_j   = sum_o ds_o(j-o) theta_{j-o}
        dg_j     = sum_o a_o(j-o) ybar_{j-o}

    with a_o(i) = exp(s_o(i) - m_i) / denom_i over valid i + o,
    u_o(i) = ybar_i . g_{i+o} and ds_o(i) = a_o(i) (u_o(i) - c_i) r_i
    [theta_i . phi_{i+o} > 0]. The -o terms are the +o terms of i = j - o
    rolled to j, masked by the validity of i."""
    theta, phi, g, ybar, scal = (t.float()
                                 for t in (theta, phi, g, ybar, scal))
    r, m, den, c = (scal[..., k:k + 1] for k in range(4))
    den = torch.clamp(den, min=1e-12)
    logits, dots, _ = _edge_logits(theta, phi, offsets)
    a = torch.exp(logits - m) / den
    back = valid_masks(theta.shape[1:4], [(-dz, -dy, -dx) for dz, dy, dx
                                          in offsets], theta.device)
    dtheta, dphi, dg = (torch.zeros_like(t) for t in (theta, phi, g))
    for k, off in enumerate(offsets):
        ak = a[..., k:k + 1]
        u = (ybar * _shift(g, off)).sum(-1, keepdim=True)
        ds = torch.where(dots[..., k:k + 1] > 0, ak * (u - c) * r, 0.0)
        dtheta = dtheta + ds * _shift(phi, off)
        neg = (-off[0], -off[1], -off[2])
        vi = back[..., k:k + 1]
        dphi = dphi + torch.where(vi, _shift(ds * theta, neg), 0.0)
        dg = dg + torch.where(vi, _shift(ak * ybar, neg), 0.0)
    return dtheta, dphi, dg


def stencil_attention_bwd(theta, phi, g, ybar, scal, offsets=KERNEL_OFFSETS):
    """Kernel wrapper of stencil_attention_bwd_plain: CUDA tensors launch
    csrc/stencil_attention.cu's gradient pass (f32, F = G = 8, the
    18-offset stencil, else raise); CPU tensors take the plain version."""
    if not theta.is_cuda:
        return stencil_attention_bwd_plain(theta, phi, g, ybar, scal,
                                           offsets)
    B, D, H, W = _check_grid("stencil_attention_bwd", offsets, theta, phi,
                             g, ybar)
    if tuple(scal.shape) != (B, D, H, W, 4):
        raise ValueError(f"stencil_attention_bwd: scal {tuple(scal.shape)} "
                         f"does not fit {(B, D, H, W)}")
    _build.check_operand(scal, torch.float32, "stencil_attention_bwd scal")
    dtheta, dphi, dg = (torch.empty_like(t) for t in (theta, phi, g))
    if dtheta.numel() == 0:
        return dtheta, dphi, dg
    plan = bwd_plan(B, D, H, W)
    _build.launch("stencil_attention_bwd_f32", theta.data_ptr(),
                  phi.data_ptr(), g.data_ptr(), ybar.data_ptr(),
                  scal.data_ptr(), dtheta.data_ptr(), dphi.data_ptr(),
                  dg.data_ptr(), B, D, H, W, _args(plan["args"]))
    stencil_attention_bwd.launches += 1
    return dtheta, dphi, dg


stencil_attention_bwd.launches = 0


class StencilAttentionFunction(torch.autograd.Function):
    """The stencil attention with its two-pass gradient: the custom VJP of
    dram_tpu's stencil_attention (_vjp_fwd saves theta, phi and g;
    _vjp_bwd runs the statistics pass, then the gradient pass). On CUDA
    tensors each pass is its kernel; on CPU tensors its plain version.

    apply(theta, phi, g, offsets) -> (B, D, H, W, G)."""

    @staticmethod
    def forward(ctx, theta, phi, g, offsets):
        ctx.offsets = offsets
        ctx.save_for_backward(theta, phi, g)
        return _forward(theta, phi, g, offsets)

    @staticmethod
    def backward(ctx, ybar):
        theta, phi, g = ctx.saved_tensors
        ybar = ybar.contiguous()
        scal = stencil_attention_scal(theta, phi, g, ybar, ctx.offsets)
        dtheta, dphi, dg = stencil_attention_bwd(theta, phi, g, ybar, scal,
                                                 ctx.offsets)
        return dtheta, dphi, dg, None


def stencil_attention(theta, phi, g, offsets=KERNEL_OFFSETS):
    """Kernel wrapper of stencil_attention_plain, differentiable through
    StencilAttentionFunction: CUDA tensors launch csrc/stencil_attention.cu
    (f32, F = G = 8, the 18-offset stencil, else raise) forward and
    backward; CPU tensors take the plain versions."""
    return StencilAttentionFunction.apply(theta, phi, g,
                                          tuple(map(tuple, offsets)))


stencil_attention.launches = 0

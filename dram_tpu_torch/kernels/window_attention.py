"""Stencil attention of the PCM refinement (merge type
'scaled_dot_product_relu').

Port of dram_tpu/core/pallas/window_attention.py:stencil_attention
(forward, _fwd_kernel), which dram_tpu/models/pcm.py calls on its
use_pallas branch. CUDA source: csrc/stencil_attention.cu. The plain
version is the roll+mask formulation of dram_tpu/models/pcm.py.
"""

from __future__ import annotations

import functools

import torch

from . import _build


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


def stencil_attention_plain(theta, phi, g, offsets=KERNEL_OFFSETS):
    """theta, phi: (B, D, H, W, F); g: (B, D, H, W, G) -> (B, D, H, W, G).

    Per voxel, a softmax over the valid stencil neighbours j of
    relu(theta_i . phi_j) / sqrt(deg_i), aggregating g_j, in f32."""
    theta, phi, g = theta.float(), phi.float(), g.float()
    valid = valid_masks(theta.shape[1:4], offsets, theta.device)
    deg = valid.sum(-1).float()
    dots = torch.stack([(theta * _shift(phi, off)).sum(-1)
                        for off in offsets], dim=-1)
    logits = torch.relu(dots) / torch.sqrt(torch.clamp(deg, min=1.0))[..., None]
    logits = torch.where(valid, logits, torch.tensor(float("-inf"),
                                                     device=theta.device))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(logits - m) * valid
    w = e / torch.clamp(e.sum(-1, keepdim=True), min=1e-12)
    out = torch.zeros_like(g)
    for k, off in enumerate(offsets):
        out = out + w[..., k:k + 1] * _shift(g, off)
    return out


def stencil_attention(theta, phi, g, offsets=KERNEL_OFFSETS):
    """Kernel wrapper: CUDA tensors launch csrc/stencil_attention.cu (f32,
    F = G = 8, the 18-offset stencil, else raise); CPU tensors take the
    plain version."""
    if not theta.is_cuda:
        return stencil_attention_plain(theta, phi, g, offsets)
    if tuple(offsets) != KERNEL_OFFSETS:
        raise ValueError("stencil_attention: the kernel implements the "
                         "k=3, connectivity-2, no-self-loop stencil only")
    B, D, H, W, Fd = theta.shape
    if Fd != 8 or g.shape[-1] != 8 or tuple(phi.shape) != tuple(theta.shape) \
            or tuple(g.shape[:4]) != (B, D, H, W):
        raise ValueError(f"stencil_attention: needs F = G = 8 on one grid, "
                         f"got {tuple(theta.shape)}, {tuple(phi.shape)}, "
                         f"{tuple(g.shape)}")
    for t, name in ((theta, "theta"), (phi, "phi"), (g, "g")):
        _build.check_operand(t, torch.float32, f"stencil_attention {name}")
    out = torch.empty_like(g)
    _build.launch("stencil_attention_f32", theta.data_ptr(), phi.data_ptr(),
                  g.data_ptr(), out.data_ptr(), B, D, H, W)
    stencil_attention.launches += 1
    return out


stencil_attention.launches = 0

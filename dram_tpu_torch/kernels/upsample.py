"""Align-corners 2x trilinear upsample on NDHWC volumes, and its adjoint.

Port of the decoder upsample of the JAX package: dram_tpu/core/pallas/
upsample.py:up2_depth_flat (forward; backward _bwd_call) and the in-plane
einsum passes of core/pallas/cm.py:upsample2x_cm with the adjoints XLA
derives from them, each direction done in one pass. CUDA source:
csrc/upsample2x.cu.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import _build


def upsample2x_plain(x):
    """(B, D, H, W, C) -> (B, 2D, 2H, 2W, C): F.interpolate trilinear,
    align_corners=True, computed in f32 and returned in x's dtype."""
    y = F.interpolate(x.permute(0, 4, 1, 2, 3).float(), scale_factor=2,
                      mode="trilinear", align_corners=True)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


def upsample2x(x):
    """Kernel wrapper: CUDA bf16 tensors launch csrc/upsample2x.cu
    (C % 8 == 0, else raise); CPU tensors take the plain version."""
    if not x.is_cuda:
        return upsample2x_plain(x)
    B, D, H, W, C = x.shape
    if C % 8:
        raise ValueError(f"upsample2x: needs C % 8 == 0, got {C}")
    _build.check_operand(x, torch.bfloat16, "upsample2x x")
    y = torch.empty((B, 2 * D, 2 * H, 2 * W, C), dtype=x.dtype,
                    device=x.device)
    _build.launch("upsample2x_bf16", x.data_ptr(), y.data_ptr(),
                  B, D, H, W, C)
    upsample2x.launches += 1
    return y


upsample2x.launches = 0


@functools.lru_cache(maxsize=16)
def _up2_matrix(n):
    """(2n, n) f32 align-corners 2x interpolation matrix with the
    kernels' f32 arithmetic: t = ((n-1)/(2n-1)) * o, lo = floor(t),
    hi = min(lo + 1, n - 1), weights (1 - f, f) with f = t - lo."""
    scale = torch.tensor(n - 1, dtype=torch.float32) / (2 * n - 1) \
        if n > 1 else torch.tensor(0.0)
    t = scale * torch.arange(2 * n, dtype=torch.float32)
    lo = torch.clamp(torch.floor(t), max=n - 1)
    f = t - lo
    lo = lo.long()
    hi = torch.clamp(lo + 1, max=n - 1)
    rows = torch.arange(2 * n)
    m = torch.zeros((2 * n, n), dtype=torch.float32)
    m.index_put_((rows, lo), 1.0 - f, accumulate=True)
    m.index_put_((rows, hi), f, accumulate=True)
    return m


def upsample2x_bwd_plain(dy):
    """Adjoint of upsample2x: (B, 2D, 2H, 2W, C) cotangent ->
    (B, D, H, W, C), three separable f32 matrix passes (the transposed
    interpolation matrices), returned in dy's dtype."""
    x = dy.float()
    for ax in (1, 2, 3):
        m = _up2_matrix(x.shape[ax] // 2).to(x.device)
        x = torch.movedim(torch.movedim(x, ax, -1) @ m, -1, ax)
    return x.to(dy.dtype).contiguous()


def upsample2x_bwd(dy):
    """Kernel wrapper of upsample2x_bwd_plain: CUDA bf16 tensors launch
    csrc/upsample2x.cu's one-pass gather adjoint (even sizes, C % 8 == 0,
    else raise); CPU tensors take the plain version."""
    if not dy.is_cuda:
        return upsample2x_bwd_plain(dy)
    B, D2, H2, W2, C = dy.shape
    if D2 % 2 or H2 % 2 or W2 % 2 or C % 8:
        raise ValueError(f"upsample2x_bwd: needs even D, H, W and "
                         f"C % 8 == 0, got {tuple(dy.shape)}")
    _build.check_operand(dy, torch.bfloat16, "upsample2x_bwd dy")
    dx = torch.empty((B, D2 // 2, H2 // 2, W2 // 2, C), dtype=dy.dtype,
                     device=dy.device)
    _build.launch("upsample2x_bwd_bf16", dy.data_ptr(), dx.data_ptr(),
                  B, D2 // 2, H2 // 2, W2 // 2, C)
    upsample2x_bwd.launches += 1
    return dx


upsample2x_bwd.launches = 0


class Upsample2x(torch.autograd.Function):
    """upsample2x with its one-pass adjoint upsample2x_bwd."""

    @staticmethod
    def forward(ctx, x):
        return upsample2x(x)

    @staticmethod
    def backward(ctx, dy):
        return upsample2x_bwd(dy.contiguous())

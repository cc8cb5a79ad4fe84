"""2x2x2 stride-2 max-pool on NDHWC volumes, and its gradient.

Port of dram_tpu/core/pallas/pool.py:maxpool2_flat (forward) and its
custom VJP _mp_vjp_bwd (the cotangent split evenly across tied maxima,
pool.py:24-26), reached in the JAX package through
core/pallas/cm.py:maxpool2_cm on the fused stack; and of the VJP of flax's
nn.max_pool on the unfused stack (dram_tpu/models/blocks.py:384), which
gives the cotangent to the first tied maximum. CUDA source:
csrc/maxpool2.cu.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build


def maxpool2_plain(x):
    """(B, D, H, W, C) -> (B, D/2, H/2, W/2, C), F.max_pool3d."""
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), kernel_size=2, stride=2)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def maxpool2(x):
    """Kernel wrapper: CUDA bf16 tensors launch csrc/maxpool2.cu (even
    D, H, W and C % 8 == 0, else raise); CPU tensors take the plain
    version."""
    if not x.is_cuda:
        return maxpool2_plain(x)
    B, D, H, W, C = x.shape
    if D % 2 or H % 2 or W % 2 or C % 8:
        raise ValueError(f"maxpool2: needs even D, H, W and C % 8 == 0, "
                         f"got {tuple(x.shape)}")
    _build.check_operand(x, torch.bfloat16, "maxpool2 x")
    y = torch.empty((B, D // 2, H // 2, W // 2, C), dtype=x.dtype,
                    device=x.device)
    _build.launch("maxpool2_bf16", x.data_ptr(), y.data_ptr(), B, D, H, W, C)
    maxpool2.launches += 1
    return y


maxpool2.launches = 0


def maxpool2_bwd_plain(x, g, first=False):
    """dx (B, D, H, W, C) of the 2x2x2 max-pool from its input x and the
    pooled cotangent g, in f32 and returned in x's dtype.

    first=False: g / (number of tied maxima) at every window position equal
    to the window's maximum, 0 elsewhere (jnp reduce-max's VJP, the fused
    path's). first=True: all of g at the first maximum of the window in
    row-major (dz, dy, dx) order (torch.argmax returns the first), 0
    elsewhere: the VJP of flax's nn.max_pool (XLA select-and-scatter), the
    unfused path's. (F.max_pool3d's backward is neither.)"""
    B, D, H, W, C = x.shape
    xw = x.float().reshape(B, D // 2, 2, H // 2, 2, W // 2, 2, C)
    gw = g.float().reshape(B, D // 2, 1, H // 2, 1, W // 2, 1, C)
    if first:
        # window positions last, in (dz, dy, dx) order
        win = xw.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(
            B, D // 2, H // 2, W // 2, C, 8)
        pick = F.one_hot(win.argmax(-1), 8).bool().reshape(
            B, D // 2, H // 2, W // 2, C, 2, 2, 2).permute(
            0, 1, 5, 2, 6, 3, 7, 4)
        return torch.where(pick, gw, 0.0).reshape(x.shape).to(x.dtype)
    eq = xw == xw.amax(dim=(2, 4, 6), keepdim=True)
    cnt = eq.sum(dim=(2, 4, 6), keepdim=True).float()
    share = gw / torch.clamp(cnt, min=1.0)
    return torch.where(eq, share, 0.0).reshape(x.shape).to(x.dtype)


def maxpool2_bwd_first_plain(x, g):
    """maxpool2_bwd_plain's first-maximum rule."""
    return maxpool2_bwd_plain(x, g, first=True)


def _launch_bwd(x, g, first, name):
    """One launch of csrc/maxpool2.cu's backward on CUDA bf16 tensors;
    the callers count it."""
    B, D, H, W, C = x.shape
    if D % 2 or H % 2 or W % 2 or C % 8:
        raise ValueError(f"{name}: needs even D, H, W and C % 8 == 0, "
                         f"got {tuple(x.shape)}")
    if tuple(g.shape) != (B, D // 2, H // 2, W // 2, C):
        raise ValueError(f"{name}: g {tuple(g.shape)} does not fit "
                         f"x {tuple(x.shape)}")
    _build.check_operand(x, torch.bfloat16, f"{name} x")
    _build.check_operand(g, torch.bfloat16, f"{name} g")
    dx = torch.empty_like(x)
    _build.launch("maxpool2_bwd_bf16", x.data_ptr(), g.data_ptr(),
                  dx.data_ptr(), B, D, H, W, C, int(first))
    return dx


def maxpool2_bwd(x, g):
    """Kernel wrapper of maxpool2_bwd_plain (ties split evenly): CUDA bf16
    tensors launch csrc/maxpool2.cu's backward; CPU tensors take the
    plain version."""
    if not x.is_cuda:
        return maxpool2_bwd_plain(x, g)
    dx = _launch_bwd(x, g, False, "maxpool2_bwd")
    maxpool2_bwd.launches += 1
    return dx


maxpool2_bwd.launches = 0


def maxpool2_bwd_first(x, g):
    """Kernel wrapper of maxpool2_bwd_first_plain: CUDA bf16 tensors launch
    csrc/maxpool2.cu's backward in its first-maximum mode; CPU tensors
    take the plain version."""
    if not x.is_cuda:
        return maxpool2_bwd_first_plain(x, g)
    dx = _launch_bwd(x, g, True, "maxpool2_bwd_first")
    maxpool2_bwd_first.launches += 1
    return dx


maxpool2_bwd_first.launches = 0


class MaxPool2(torch.autograd.Function):
    """maxpool2 with the tie-splitting gradient maxpool2_bwd (the fused
    stack's pool)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return maxpool2(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return maxpool2_bwd(x, g.contiguous())


class MaxPool2First(MaxPool2):
    """maxpool2 with the first-maximum gradient maxpool2_bwd_first (the
    unfused stack's pool, flax's nn.max_pool)."""

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return maxpool2_bwd_first(x, g.contiguous())

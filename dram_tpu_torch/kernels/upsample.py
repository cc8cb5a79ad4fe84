"""Align-corners 2x trilinear upsample on NDHWC volumes.

Port of the decoder upsample of the JAX package: dram_tpu/core/pallas/
upsample.py:up2_depth_flat (forward) and the in-plane einsum passes of
core/pallas/cm.py:upsample2x_cm, done in one pass. CUDA source:
csrc/upsample2x.cu.
"""

from __future__ import annotations

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

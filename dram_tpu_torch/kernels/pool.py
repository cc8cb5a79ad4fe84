"""2x2x2 stride-2 max-pool on NDHWC volumes.

Port of dram_tpu/core/pallas/pool.py:maxpool2_flat (forward), reached in
the JAX package through core/pallas/cm.py:maxpool2_cm. CUDA source:
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

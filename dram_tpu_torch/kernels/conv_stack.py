"""3x3x3 convolution with the eval-mode BatchNorm affine and ReLU fused
into its epilogue, on NDHWC volumes; the input may come in two parts that
act as one channel concat.

Port of dram_tpu/core/pallas/fused_stack.py:conv_cm (kernel _cbr_kernel)
as fused_cbr2 / _fused_fwd drive it at eval, with the stack-exit affine
pass folded in. CUDA source: csrc/conv3x3x3.cu.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build


def fold_bn(gamma, beta, mean, var, eps=1e-5):
    """Running-stat BatchNorm as one per-channel (scale, shift) in f32
    (dram_tpu fused_stack._affine_from_stats)."""
    s = gamma.float() * torch.rsqrt(var.float() + eps)
    return s, beta.float() - mean.float() * s


def conv3x3x3_plain(x1, w, scale, shift, x2=None):
    """relu(conv3d([x1, x2], w) * scale + shift), F.conv3d in f32.

    x1: (B, D, H, W, C1) and optional x2: (B, D, H, W, C2), concatenated
    along channels; w: (Co, C1 + C2, 3, 3, 3), rounded to x1's dtype as
    the kernel rounds it; scale, shift: (Co,) f32. Returns
    (B, D, H, W, Co) in x1's dtype."""
    x = x1 if x2 is None else torch.cat([x1, x2], dim=-1)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3).float(),
                 w.to(x1.dtype).float(), padding=1)
    y = torch.relu(y * scale.float()[:, None, None, None]
                   + shift.float()[:, None, None, None])
    return y.permute(0, 2, 3, 4, 1).to(x1.dtype).contiguous()


def conv3x3x3(x1, w, scale, shift, x2=None):
    """Kernel wrapper of conv3x3x3_plain: CUDA tensors launch
    csrc/conv3x3x3.cu (bf16 activations; w is cast to bf16 in the
    kernel's (27, Ci, Co) layout); CPU tensors take the plain version."""
    if not x1.is_cuda:
        return conv3x3x3_plain(x1, w, scale, shift, x2)
    B, D, H, W, C1 = x1.shape
    _build.check_operand(x1, torch.bfloat16, "conv3x3x3 x1")
    C2 = 0
    if x2 is not None:
        if tuple(x2.shape[:4]) != (B, D, H, W):
            raise ValueError(f"conv3x3x3: part shapes differ "
                             f"{tuple(x1.shape)} vs {tuple(x2.shape)}")
        _build.check_operand(x2, torch.bfloat16, "conv3x3x3 x2")
        C2 = x2.shape[-1]
    Co, Ci = w.shape[:2]
    if Ci != C1 + C2 or tuple(w.shape[2:]) != (3, 3, 3):
        raise ValueError(f"conv3x3x3: weight {tuple(w.shape)} does not fit "
                         f"{C1} + {C2} input channels")
    wk = w.permute(2, 3, 4, 1, 0).reshape(27, Ci, Co) \
        .to(device=x1.device, dtype=torch.bfloat16).contiguous()
    scale = scale.to(device=x1.device, dtype=torch.float32).contiguous()
    shift = shift.to(device=x1.device, dtype=torch.float32).contiguous()
    _build.check_operand(wk, torch.bfloat16, "conv3x3x3 w")
    y = torch.empty((B, D, H, W, Co), dtype=torch.bfloat16, device=x1.device)
    _build.launch("conv3x3x3_bf16", x1.data_ptr(), C1,
                  x2.data_ptr() if x2 is not None else None, C2,
                  wk.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                  y.data_ptr(), B, D, H, W, Co)
    conv3x3x3.launches += 1
    return y


conv3x3x3.launches = 0

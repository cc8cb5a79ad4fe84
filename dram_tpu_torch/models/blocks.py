"""3-D conv building blocks, eval mode, NDHWC.

Port of dram_tpu/models/blocks.py: `ConvStack` :185 (conv -> BN -> ReLU,
twice), `ConvPoolBlock5d` :342, `ConvBlock5d`, `UpsampleConvBlock5d` :389,
`Conv1x1` :124 and `crop_concat` :79. BatchNorm runs from its running
statistics only and is folded into the conv kernel's epilogue. Submodule
and parameter names follow the flax tree (see dram_tpu_torch.weights).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..kernels import conv_stack, pool, upsample


class Conv3x3(nn.Module):
    """Bias-free 3x3x3 conv weight, torch layout (Co, Ci, 3, 3, 3)."""

    def __init__(self, ci, co):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(co, ci, 3, 3, 3))


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm (eps 1e-5) as a per-channel affine."""

    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def affine(self):
        return conv_stack.fold_bn(self.weight, self.bias, self.running_mean,
                                  self.running_var, self.eps)

    def forward(self, x):
        s, t = self.affine()
        return x.float() * s + t


class Conv1x1(nn.Module):
    """1x1x1 conv (weight (Co, Ci, 1, 1, 1)) over the channel axis of an
    NDHWC tensor, computed in f32 and returned in the input's dtype."""

    def __init__(self, ci, co):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(co, ci, 1, 1, 1))
        self.bias = nn.Parameter(torch.zeros(co))

    def forward(self, x):
        w = self.weight.reshape(self.weight.shape[:2])
        return (x.float() @ w.T + self.bias).to(x.dtype)


def crop_to(skip, like):
    """Centre-crop `skip` to `like`'s spatial size, the crop of
    crop_concat (the channel concat itself stays virtual: ConvStack takes
    the two parts)."""
    sl = [slice(None)]
    for a, b in zip(like.shape[1:4], skip.shape[1:4]):
        start = int(np.ceil((b - a) / 2))
        sl.append(slice(start, start + a))
    return skip[tuple(sl)].contiguous()


class ConvStack(nn.Module):
    """(3x3x3 conv -> BN -> ReLU) x 2; each conv runs as one kernel with
    BN and ReLU in its epilogue. The first conv may take two input parts
    that act as their channel concat."""

    def __init__(self, ci, features):
        super().__init__()
        f0, f1 = features
        self.conv_0 = Conv3x3(ci, f0)
        self.BatchNorm_0 = BatchNorm(f0)
        self.conv_1 = Conv3x3(f0, f1)
        self.BatchNorm_1 = BatchNorm(f1)

    def forward(self, x, x2=None):
        s0, t0 = self.BatchNorm_0.affine()
        y = conv_stack.conv3x3x3(x, self.conv_0.weight, s0, t0, x2=x2)
        s1, t1 = self.BatchNorm_1.affine()
        return conv_stack.conv3x3x3(y, self.conv_1.weight, s1, t1)


class ConvBlock5d(nn.Module):
    """Plain conv stack (the bottleneck)."""

    def __init__(self, ci, features):
        super().__init__()
        self.convs = ConvStack(ci, features)

    def forward(self, x):
        return self.convs(x)


class ConvPoolBlock5d(nn.Module):
    """Conv stack returning (pre-pool features, 2x max-pooled features)."""

    def __init__(self, ci, features):
        super().__init__()
        self.convs = ConvStack(ci, features)

    def forward(self, x):
        y = self.convs(x)
        return y, pool.maxpool2(y)


class UpsampleConvBlock5d(nn.Module):
    """Align-corners 2x upsample -> [up, centre-cropped skip] -> conv
    stack; the concat is never materialized."""

    def __init__(self, ci, features):
        super().__init__()
        self.convs = ConvStack(ci, features)

    def forward(self, x, skip):
        up = upsample.upsample2x(x)
        if tuple(skip.shape[1:4]) != tuple(up.shape[1:4]):
            skip = crop_to(skip, up)
        return self.convs(up, skip)

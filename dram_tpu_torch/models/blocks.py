"""3-D conv building blocks, NDHWC, in eval and training mode.

Port of dram_tpu/models/blocks.py: `ConvStack` :185 (conv -> BN -> ReLU,
twice), `ConvPoolBlock5d` :342, `ConvBlock5d`, `UpsampleConvBlock5d` :389,
`Conv1x1` :124 and `crop_concat` :79. A stack runs fused (the JAX
package's use_fused_stack, its accelerator default) or unfused:

- fused: `.eval()` runs BatchNorm from its running statistics, folded
  into the conv kernel's epilogue; `.train()` runs it on batch statistics
  through ConvStackFunction (the fused stack's training forward and
  backward);
- unfused (:280-306): each conv is its own autograd Function
  (kernels/conv3d.py, the port of PallasConv3d), followed by flax's
  BatchNorm formula and a ReLU, with PyTorch autograd through the
  BatchNorm as JAX's autodiff goes through flax's; the pool's gradient
  takes the first tied maximum (flax's nn.max_pool).

Both update the running statistics as flax does. Submodule and parameter
names follow the flax tree, the same for both (see dram_tpu_torch.weights).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..kernels import conv3d, conv_stack, pool, upsample


class Conv3x3(nn.Module):
    """Bias-free 3x3x3 conv weight, torch layout (Co, Ci, 3, 3, 3)."""

    def __init__(self, ci, co):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(co, ci, 3, 3, 3))


class BatchNorm(nn.Module):
    """flax nn.BatchNorm (eps 1e-5, momentum 0.9) over the channel axis.

    Eval: the running statistics. Train: the batch mean and the BIASED
    variance E[x^2] - E[x]^2 clamped at 0, in f32 (flax; torch.nn.BatchNorm3d
    keeps the unbiased one), and the running statistics move as
    r <- 0.9 r + 0.1 batch (flax's momentum, which torch.nn.BatchNorm3d
    reads the other way round)."""

    momentum = 0.9

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

    @torch.no_grad()
    def update_running(self, mean, var):
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1.0 - m) * var)

    def forward(self, x):
        """flax's _compute_stats and _normalize: (x - mean) *
        (rsqrt(var + eps) * scale) + bias in f32, returned in x's dtype.
        The statistics and the normalization each cast x to f32, as
        flax's two casts do, so in bf16 the two parts of x's gradient are
        rounded to bf16 and added in bf16, as JAX's autodiff adds them."""
        if self.training:
            xs = x.float()
            dims = tuple(range(xs.dim() - 1))
            mean = xs.mean(dims)
            var = torch.clamp((xs * xs).mean(dims) - mean * mean, min=0.0)
            self.update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x.float() - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(x.dtype)


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
    """(3x3x3 conv -> BN -> ReLU) x 2. The first conv may take two input
    parts that act as their channel concat.

    fused=True: in eval each conv runs as one kernel with the running-stat
    BN and ReLU in its epilogue (rounded once); in train
    ConvStackFunction on batch statistics, then the running-stat update.
    fused=False (the JAX package's use_fused_stack=False): each conv is
    Conv3dFunction, whose raw output is rounded to the activation dtype,
    then BatchNorm (flax's formula in f32, on batch or running
    statistics, rounded again) and ReLU."""

    def __init__(self, ci, features, fused=True):
        super().__init__()
        f0, f1 = features
        self.fused = fused
        self.conv_0 = Conv3x3(ci, f0)
        self.BatchNorm_0 = BatchNorm(f0)
        self.conv_1 = Conv3x3(f0, f1)
        self.BatchNorm_1 = BatchNorm(f1)

    def forward(self, x, x2=None):
        bn0, bn1 = self.BatchNorm_0, self.BatchNorm_1
        if not self.fused:
            y = torch.relu(bn0(conv3d.Conv3dFunction.apply(
                x, x2, self.conv_0.weight)))
            return torch.relu(bn1(conv3d.Conv3dFunction.apply(
                y, None, self.conv_1.weight)))
        if not self.training:
            s0, t0 = bn0.affine()
            y = conv_stack.conv3x3x3(x, self.conv_0.weight, s0, t0, x2=x2)
            s1, t1 = bn1.affine()
            return conv_stack.conv3x3x3(y, self.conv_1.weight, s1, t1)
        y, m0, v0, m1, v1 = conv_stack.ConvStackFunction.apply(
            x, x2, self.conv_0.weight, bn0.weight, bn0.bias,
            self.conv_1.weight, bn1.weight, bn1.bias, bn0.eps)
        bn0.update_running(m0, v0)
        bn1.update_running(m1, v1)
        return y


class ConvBlock5d(nn.Module):
    """Plain conv stack (the bottleneck)."""

    def __init__(self, ci, features, fused=True):
        super().__init__()
        self.convs = ConvStack(ci, features, fused)

    def forward(self, x):
        return self.convs(x)


class ConvPoolBlock5d(nn.Module):
    """Conv stack returning (pre-pool features, 2x max-pooled features);
    the pool's gradient splits ties (fused) or takes the first maximum
    (unfused, flax's nn.max_pool)."""

    def __init__(self, ci, features, fused=True):
        super().__init__()
        self.convs = ConvStack(ci, features, fused)
        self.pool = pool.MaxPool2 if fused else pool.MaxPool2First

    def forward(self, x):
        y = self.convs(x)
        return y, self.pool.apply(y)


class UpsampleConvBlock5d(nn.Module):
    """Align-corners 2x upsample -> [up, centre-cropped skip] -> conv
    stack; the concat is never materialized. On the unfused path the JAX
    package upsamples with resize3d (f32 passes, rounded once), which is
    this one-pass kernel's function and rounding."""

    def __init__(self, ci, features, fused=True):
        super().__init__()
        self.convs = ConvStack(ci, features, fused)

    def forward(self, x, skip):
        up = upsample.Upsample2x.apply(x)
        if tuple(skip.shape[1:4]) != tuple(up.shape[1:4]):
            skip = crop_to(skip, up)
        return self.convs(up, skip)

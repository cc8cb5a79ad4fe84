"""Parameter initialization of the port: the config's HeNorm.

Port of dram_tpu/models/initializers.py (`HeNorm`, the kaiming-normal
conv init with bias 0.01, unit BN scale and zero BN shift, torch-default
Linear init) together with the per-module inits the flax modules carry
(dram_tpu/models/blocks.py): the k x k x k conv kernels draw from
N(0, 2 / fan_in) and their biases (stacks without a norm) start at 0.01,
the 1x1x1 top layer keeps flax's lecun-normal kernel (truncated at 2 std)
and zero bias, BatchNorm starts at scale 1, shift 0, running mean 0 and
running variance 1, GroupNorm at scale 1 and shift 0, PReLU's slope at
0.01 (flax's default), the PCM's dense layers (geo_theta and geo_phi
too) like torch's Linear. Draws come from an explicit torch.Generator;
they are not jax.random's bits, so the two packages agree in
distribution only.

dram_tpu's HeNorm keeps `mode` (fan_in, fan_out, ...) in its
conv_kernel_init, which no module reads: its blocks initialise every conv
with kaiming_normal_conv (fan_in). So HeNorm here accepts every mode and
initialises with fan_in, as dram_tpu trains.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .blocks import BatchNorm, Conv1x1, Conv3d, GroupNorm, PReLU

# jax.nn.initializers.variance_scaling(..., "truncated_normal"): the std
# of a unit normal truncated to [-2, 2], divided out so the draw keeps the
# requested variance
_TRUNC_STD = 0.87962566103423978


def _fan_in(weight):
    return weight.shape[1] * math.prod(weight.shape[2:])


class HeNorm:
    """INITIALIZER = {"method": "models.HeNorm", "mode": ...}:
    `HeNorm(mode)(model, generator)` initializes `model` in place, with
    fan_in whatever the mode (see the module's docstring)."""

    def __init__(self, mode="fan_in", **kwargs):
        self.mode = mode

    def __repr__(self):
        return f"HeNorm(mode={self.mode})"

    @torch.no_grad()
    def __call__(self, model, generator):
        for m in model.modules():
            if isinstance(m, Conv3d):
                m.weight.normal_(0.0, math.sqrt(2.0 / _fan_in(m.weight)),
                                 generator=generator)
                if m.bias is not None:
                    m.bias.fill_(0.01)
            elif isinstance(m, Conv1x1):
                std = math.sqrt(1.0 / _fan_in(m.weight)) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                m.bias.zero_()
            elif isinstance(m, (BatchNorm, GroupNorm)):
                if m.weight is not None:
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                if isinstance(m, BatchNorm):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
            elif isinstance(m, PReLU):
                m.negative_slope.fill_(0.01)
            elif isinstance(m, nn.Linear):
                nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5),
                                         generator=generator)
                if m.bias is not None:
                    bound = 1.0 / math.sqrt(m.weight.shape[1])
                    m.bias.uniform_(-bound, bound, generator=generator)
        return model

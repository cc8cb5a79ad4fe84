"""3-D conv building blocks, NDHWC, in eval and training mode.

Port of dram_tpu/models/blocks.py: `ConvStack` :185 (conv -> norm -> act
[-> dropout] per conv), `ConvPoolBlock5d` :342, `ConvBlock5d`,
`UpsampleConvBlock5d` :389, `Conv1x1` :124, `make_norm` :30, `make_act`
:71 and `crop_concat` :79 (as `crop_to`: the decoder's concat stays
virtual, ConvStack takes the two parts). A stack runs fused (the JAX package's
use_fused_stack, its accelerator default) or unfused:

- fused, where dram_tpu's fused_stack_supported holds (two 3x3x3 SAME
  convs, 'bn', 'relu', no dropout;
  dram_tpu/core/pallas/fused_stack.py:692-722): `.eval()` runs BatchNorm
  from its running statistics, folded into the conv kernel's epilogue;
  `.train()` runs it on batch statistics through ConvStackFunction (the
  fused stack's training forward and backward);
- unfused (:280-306), every other stack: each 3x3x3 stride-1 SAME conv is
  its own autograd Function (kernels/conv3d.py, the port of PallasConv3d);
  a conv of another kernel size or padding (VALID) runs F.conv3d, as
  dram_tpu runs XLA's nn.Conv where its Pallas conv does not compute that
  conv; then the norm (make_norm: flax's BatchNorm or GroupNorm formula in
  f32), the activation (ReLU, or one PReLU whose slope the stack's convs
  share: make_act runs once per stack) and dropout, with PyTorch autograd
  through them as JAX's autodiff goes through flax's; the pool's gradient
  takes the first tied maximum (flax's nn.max_pool).

A stack without a norm has conv biases (dram_tpu/models/unet3d.py:71).
Both paths update the BatchNorm running statistics as flax does. Under
data parallelism `set_process_group` hands the process group to every
BatchNorm and fused stack (dram_tpu's model.clone(axis_name=...)): the
train-mode statistics become the global batch's, so the running
statistics agree on every rank.
Submodule and parameter names follow the flax tree, the same for both
(see dram_tpu_torch.weights).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.mesh import all_reduce_sum, world_size
from ..core.resample import resize3d, upsample2x_local
from ..kernels import conv3d, conv_stack, pool, upsample

def _as_list(v, n):
    if isinstance(v, (tuple, list)):
        return list(v)
    return [v] * n


class Conv3d(nn.Module):
    """A k x k x k conv weight, torch layout (Co, Ci, k, k, k), and its
    bias when `bias` (flax's nn.Conv / PallasConv3d parameters)."""

    def __init__(self, ci, co, k=3, bias=False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(co, ci, k, k, k))
        self.bias = nn.Parameter(torch.zeros(co)) if bias else None


def conv3d_plain_pad(x, w, padding):
    """A conv of any kernel size with symmetric zero padding `padding`
    (0: VALID), stride 1, NDHWC: F.conv3d in f32 on x and w rounded to
    x's dtype, returned in x's dtype (flax's nn.Conv on XLA)."""
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3),
                 w.to(x.dtype).float(), padding=padding)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)


class BatchNorm(nn.Module):
    """flax nn.BatchNorm (eps 1e-5, momentum 0.9) over the channel axis.

    Eval: the running statistics. Train: the batch mean and the BIASED
    variance E[x^2] - E[x]^2 clamped at 0, in f32 (flax; torch.nn.BatchNorm3d
    keeps the unbiased one), and the running statistics move as
    r <- 0.9 r + 0.1 batch (flax's momentum, which torch.nn.BatchNorm3d
    reads the other way round).

    `batch_only` (norms 'bnt', 'bntna': use_running_average=False in both
    of dram_tpu's models): the batch statistics in train mode too, with
    the same running-statistic update; in eval mode flax would write the
    running statistics in an apply whose batch_stats are not mutable and
    raises (ModifyScopeVariableError), so this raises too. `affine=False`
    ('bntna') has no scale or shift.

    `group` (set by set_process_group): in train mode the batch mean and
    E[x^2] are averaged over its ranks, as flax's BatchNorm with
    `axis_name` pmeans them ('bn', 'sbn'). dram_tpu builds 'bnt' and
    'bntna' and DC3DATGeneric's tap heads without `axis_name`, so under
    data parallelism their statistics stay local to a rank: `batch_only`
    norms and `cross_rank=False` ignore the group likewise."""

    momentum = 0.9

    def __init__(self, c, eps=1e-5, affine=True, batch_only=False,
                 cross_rank=True):
        super().__init__()
        self.eps = eps
        self.batch_only = batch_only
        self.cross_rank = cross_rank and not batch_only
        self.group = None
        self.weight = nn.Parameter(torch.ones(c)) if affine else None
        self.bias = nn.Parameter(torch.zeros(c)) if affine else None
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
        if self.batch_only and not self.training:
            raise RuntimeError(
                "BatchNorm without running statistics ('bnt', 'bntna') in "
                "eval mode: dram_tpu's eval apply raises there (flax writes "
                "batch_stats that the apply does not make mutable)")
        if self.training:
            xs = x.float()
            dims = tuple(range(xs.dim() - 1))
            mean, mean2 = xs.mean(dims), (xs * xs).mean(dims)
            group = self.group if self.cross_rank else None
            if group is not None:
                mean, mean2 = all_reduce_sum(torch.stack([mean, mean2]),
                                             group) / world_size(group)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            self.update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = (x.float() - mean) * mul
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)


class GroupNorm(nn.Module):
    """flax nn.GroupNorm (eps 1e-5) over (D, H, W, channels of a group)
    per sample: `groups` groups of the channels ('ln', 'lnna': one;
    'in': one per channel), the biased variance E[x^2] - E[x]^2 clamped
    at 0, in f32, (x - mean) * (rsqrt(var + eps) * scale) + bias,
    returned in x's dtype; `affine=False` ('lnna') has no scale or
    shift."""

    def __init__(self, c, groups, eps=1e-5, affine=True):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c)) if affine else None
        self.bias = nn.Parameter(torch.zeros(c)) if affine else None

    def forward(self, x):
        xs = x.float()
        B, C = xs.shape[0], xs.shape[-1]
        xg = xs.reshape(B, -1, self.groups, C // self.groups)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp((xg * xg).mean(dim=(1, 3), keepdim=True)
                          - mean * mean, min=0.0)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(xs.shape)
        if self.weight is not None:
            y = y * self.weight
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)


def set_process_group(model, group):
    """Hand the data-parallel process `group` (None: one process) to
    every BatchNorm and conv stack of `model`; returns the model."""
    for m in model.modules():
        if isinstance(m, (BatchNorm, ConvStack)):
            m.group = group
    return model


def make_norm(norm_method, c):
    """(flax module name, module) of a norm of `c` channels, or None:
    dram_tpu/models/blocks.py:make_norm. 'sbn' (cross-replica BatchNorm)
    on one device is 'bn'."""
    if norm_method in ("bn", "sbn"):
        return "BatchNorm", BatchNorm(c)
    if norm_method == "bnt":
        return "BatchNorm", BatchNorm(c, batch_only=True)
    if norm_method == "bntna":
        return "BatchNorm", BatchNorm(c, affine=False, batch_only=True)
    if norm_method == "ln":
        return "GroupNorm", GroupNorm(c, 1)
    if norm_method == "lnna":
        return "GroupNorm", GroupNorm(c, 1, affine=False)
    if norm_method == "in":
        return "GroupNorm", GroupNorm(c, c)
    if norm_method is None or norm_method == "none":
        return None
    raise NotImplementedError(f"norm method {norm_method}")


class PReLU(nn.Module):
    """flax nn.PReLU: one scalar slope (init 0.01), x where x >= 0, else
    slope * x in x's dtype."""

    def __init__(self, init=0.01):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.tensor(float(init)))

    def forward(self, x):
        return torch.where(x >= 0, x, self.negative_slope.to(x.dtype) * x)


def make_act(act_method):
    """make_act of dram_tpu/models/blocks.py: 'relu' -> None (torch.relu),
    'prelu' -> a PReLU module (one per stack)."""
    if act_method == "relu":
        return None
    if act_method == "prelu":
        return PReLU()
    raise NotImplementedError(f"act method {act_method}")


class Dropout(nn.Module):
    """flax nn.Dropout: identity in eval mode; in train mode a keep mask
    with P(keep) = 1 - rate and x / (1 - rate) where kept, 0 elsewhere.
    The mask is drawn from `generator`, an explicit torch.Generator on
    x's device that the caller sets (DC3D.set_dropout_generator); a
    train-mode forward without one raises."""

    def __init__(self, rate):
        super().__init__()
        self.rate = float(rate)
        self.generator = None

    def forward(self, x):
        if not self.training or self.rate <= 0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in train mode needs a generator "
                               "(set_dropout_generator)")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


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


def fused_supported(features, kernel_sizes, paddings, norm_method,
                    act_method, dropout):
    """The fused_stack_supported of dram_tpu (fused_stack.py:692-722) on the
    port's kernels: two 3x3x3 stride-1 SAME convs, 'bn', 'relu', no
    dropout."""
    return (len(features) == 2 and norm_method == "bn"
            and act_method == "relu" and not dropout > 0
            and all(int(k) == 3 for k in kernel_sizes)
            and all(int(p) == 1 for p in paddings))


class ConvStack(nn.Module):
    """len(features) x (conv -> norm -> act [-> dropout]). The first conv
    may take two input parts that act as their channel concat.

    fused (where fused_supported holds and `fused`): in eval each conv
    runs as one kernel with the running-stat BN and ReLU in its epilogue
    (rounded once); in train ConvStackFunction on batch statistics, then
    the running-stat update. Unfused: each 3x3x3 SAME conv is
    Conv3dFunction (kernel sizes and paddings of other values F.conv3d),
    whose raw output is rounded to the activation dtype, then the conv
    bias (no norm), the norm (flax's formula in f32, rounded again), the
    activation and dropout."""

    def __init__(self, ci, features, fused=True, kernel_sizes=3, paddings=1,
                 norm_method="bn", act_method="relu", dropout=0.0):
        super().__init__()
        n = len(features)
        self.kernel_sizes = [int(k) for k in _as_list(kernel_sizes, n)]
        self.paddings = [int(p) for p in _as_list(paddings, n)]
        self.fused = fused and fused_supported(
            features, self.kernel_sizes, self.paddings, norm_method,
            act_method, dropout)
        self.group = None
        use_bias = norm_method is None or norm_method == "none"
        self.norm_names = []
        for i, (c_in, c) in enumerate(zip([ci] + list(features[:-1]),
                                          features)):
            self.add_module(f"conv_{i}", Conv3d(c_in, c,
                                                self.kernel_sizes[i],
                                                use_bias))
            norm = make_norm(norm_method, c)
            if norm is not None:
                name = f"{norm[0]}_{i}"
                self.add_module(name, norm[1])
                self.norm_names.append(name)
        act = make_act(act_method)
        if act is not None:
            self.PReLU_0 = act
        self.drop = Dropout(dropout) if dropout > 0 else None

    def _conv(self, i, x, x2):
        conv = getattr(self, f"conv_{i}")
        if self.kernel_sizes[i] == 3 and self.paddings[i] == 1:
            y = conv3d.Conv3dFunction.apply(x, x2, conv.weight)
        else:
            if x2 is not None:
                x = torch.cat([x, x2], dim=-1)
            y = conv3d_plain_pad(x, conv.weight, self.paddings[i])
        if conv.bias is not None:
            y = y + conv.bias.to(y.dtype)
        return y

    def forward(self, x, x2=None):
        if self.fused:
            return self._fused(x, x2)
        act = getattr(self, "PReLU_0", None)
        for i in range(len(self.kernel_sizes)):
            x = self._conv(i, x, x2 if i == 0 else None)
            if self.norm_names:
                x = getattr(self, self.norm_names[i])(x)
            x = torch.relu(x) if act is None else act(x)
            if self.drop is not None:
                x = self.drop(x)
        return x

    def _fused(self, x, x2):
        bn0, bn1 = self.BatchNorm_0, self.BatchNorm_1
        if not self.training:
            s0, t0 = bn0.affine()
            y = conv_stack.conv3x3x3(x, self.conv_0.weight, s0, t0, x2=x2)
            s1, t1 = bn1.affine()
            return conv_stack.conv3x3x3(y, self.conv_1.weight, s1, t1)
        y, m0, v0, m1, v1 = conv_stack.ConvStackFunction.apply(
            x, x2, self.conv_0.weight, bn0.weight, bn0.bias,
            self.conv_1.weight, bn1.weight, bn1.bias, bn0.eps, self.group)
        bn0.update_running(m0, v0)
        bn1.update_running(m1, v1)
        return y


class ConvBlock5d(nn.Module):
    """Plain conv stack (the bottleneck)."""

    def __init__(self, ci, features, fused=True, **opts):
        super().__init__()
        self.convs = ConvStack(ci, features, fused, **opts)

    def forward(self, x):
        return self.convs(x)


class ConvPoolBlock5d(nn.Module):
    """Conv stack returning (pre-pool features, 2x max-pooled features);
    the pool's gradient splits ties (fused) or takes the first maximum
    (unfused, flax's nn.max_pool). An odd extent (VALID convs) drops its
    last plane, row or column, as nn.max_pool's VALID windows do."""

    def __init__(self, ci, features, fused=True, **opts):
        super().__init__()
        self.convs = ConvStack(ci, features, fused, **opts)
        self.pool = pool.MaxPool2 if self.convs.fused else pool.MaxPool2First

    def forward(self, x):
        y = self.convs(x)
        even = tuple(2 * (n // 2) for n in y.shape[1:4])
        src = y if even == tuple(y.shape[1:4]) else \
            y[:, :even[0], :even[1], :even[2]].contiguous()
        return y, self.pool.apply(src)


class UpsampleConvBlock5d(nn.Module):
    """Upsample -> [up, centre-cropped skip] -> conv stack; the concat
    is never materialized on the 3x3x3 paths. The align-corners 2x
    upsample is the one-pass kernel (on the unfused path the JAX package
    upsamples with resize3d, f32 passes rounded once: this kernel's
    function and rounding); `local_upsample` takes upsample2x_local and a
    scale factor other than 2 the align-corners resize3d, as dram_tpu
    does."""

    def __init__(self, ci, features, fused=True, scale_factor=2,
                 local_upsample=False, **opts):
        super().__init__()
        sf = scale_factor
        self.scale_factor = sf[0] if isinstance(sf, (tuple, list)) else sf
        self.local_upsample = local_upsample
        self.convs = ConvStack(ci, features, fused, **opts)

    def forward(self, x, skip):
        sf = self.scale_factor
        if self.local_upsample and sf == 2:
            up = upsample2x_local(x)
        elif sf == 2:
            up = upsample.Upsample2x.apply(x)
        else:
            up = resize3d(x, tuple(int(s * sf) for s in x.shape[1:4]))
        if tuple(skip.shape[1:4]) != tuple(up.shape[1:4]):
            skip = crop_to(skip, up)
        return self.convs(up, skip)

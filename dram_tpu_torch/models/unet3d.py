"""DC3D: 3-level 3-D U-Net dense-regression backbone, NDHWC; `.eval()`
and `.train()` switch its BatchNorms between running and batch statistics.

Port of dram_tpu/models/unet3d.py:35-143: encoder of ConvPool blocks,
bottleneck, decoder of upsample + [up, skip] blocks with early exit at
`stacking`, 1x1x1 top layer and an align-corners resize back to the input
size (:130-135). Stages are methods so DC3DATGeneric can tap them.
`fused_stack` is the JAX package's use_fused_stack: a conv stack runs
fused where it can (True; blocks.fused_supported) or unfused (False;
models/blocks.py). The backbone's options are dram_tpu's (:35-90):
kernel_sizes and padding_list (a per-conv list per level; VALID convs
crop the skips), norm_method, act_method, dropout (its
masks from the generator of set_dropout_generator), upsample_sf and
local_upsample; a stack without a norm has conv biases (:71).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core import ops
from ..core.resample import resize3d
from .blocks import (Conv1x1, ConvBlock5d, ConvPoolBlock5d, Dropout,
                     UpsampleConvBlock5d)


class DC3D(nn.Module):
    def __init__(self, n_layers=3,
                 base_ch_list=(32, 64, 128, 256, 256, 128, 64),
                 end_ch_list=(64, 128, 256, 512, 256, 128, 64),
                 out_ch=1, stacking=0, dtype=torch.float32,
                 fused_stack=True, pooling_method="avg",
                 padding_list=((1, 1),) * 7, kernel_sizes=None,
                 dropout=0.0, upsample_sf=2, norm_method="bn",
                 act_method="relu", local_upsample=False):
        super().__init__()
        self.pooling_method = pooling_method
        self.n_layers = n_layers
        self.dtype = dtype
        n, end = n_layers, list(end_ch_list)
        ks = list(kernel_sizes) if kernel_sizes is not None \
            else [(3, 3)] * (2 * n + 1)
        pads = list(padding_list)

        def opts(i):
            return dict(kernel_sizes=ks[i], paddings=pads[i],
                        norm_method=norm_method, act_method=act_method,
                        dropout=dropout)
        ins = [1] + end[:n - 1]  # one CT channel in
        # the decoder exits early at `stacking`; only the levels it runs
        # exist (as in the flax tree, whose names the submodules keep)
        n_us = stacking if 0 <= stacking < n else n
        for i in range(n):
            self.add_module(f"ds_{i}", ConvPoolBlock5d(
                ins[i], (base_ch_list[i], end[i]), fused_stack, **opts(i)))
        self.bg = ConvBlock5d(end[n - 1], (base_ch_list[n], end[n]),
                              fused_stack, **opts(n))
        for i in range(n_us):
            self.add_module(f"us_{i}", UpsampleConvBlock5d(
                end[n + i] + end[n - 1 - i],
                (base_ch_list[n + 1 + i], end[n + 1 + i]), fused_stack,
                scale_factor=upsample_sf, local_upsample=local_upsample,
                **opts(n + 1 + i)))
        self.ds_modules = [getattr(self, f"ds_{i}") for i in range(n)]
        self.us_modules = [getattr(self, f"us_{i}") for i in range(n_us)]
        self.top_layer = Conv1x1(end[n + n_us], out_ch)

    def set_dropout_generator(self, generator):
        """The torch.Generator every Dropout of the model draws its keep
        masks from (on the model's device)."""
        for m in self.modules():
            if isinstance(m, Dropout):
                m.generator = generator

    def encoder(self, x):
        """Returns (pre-pool feature list, pooled output)."""
        feats, h = [], x
        for ds in self.ds_modules:
            f, h = ds(h)
            feats.append(f)
        return feats, h

    def bottleneck(self, h):
        return self.bg(h)

    def decoder(self, xbg, feats):
        """Decoder features; entry 0 is the bottleneck output."""
        us_feats = [xbg]
        for us, skip in zip(self.us_modules, reversed(feats)):
            us_feats.append(us(us_feats[-1], skip))
        return us_feats

    def top(self, outs, spatial_size):
        dense = resize3d(self.top_layer(outs), spatial_size)
        return dense.float()

    def pooling_dense_features(self, dense_outs, lungs, pooling_method=None):
        return ops.pooling_dense_features(
            dense_outs, lungs, pooling_method or self.pooling_method)

    def forward(self, x):
        """x: (B, D, H, W, 1) -> (dense, dense) f32 logits."""
        x = x.to(self.dtype).contiguous()
        feats, h = self.encoder(x)
        us_feats = self.decoder(self.bottleneck(h), feats)
        dense = self.top(us_feats[-1], x.shape[1:4])
        return dense, dense

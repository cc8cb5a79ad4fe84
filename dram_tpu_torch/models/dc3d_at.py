"""DC3DATGeneric: DC3D backbone + detached attention taps + PCM
refinement, in eval and training mode.

Port of dram_tpu/models/dc3d_at.py:26-167. Selected layers (`at_layers`,
-1 meaning the raw input) are tapped, detached (JAX's stop_gradient,
:117-127: no gradient reaches the backbone through a tap), passed through
1x1x1 conv + BN + ReLU heads, resized to `at_spatial_size` and
concatenated (1 + 2 x 8 = 17 channels in the flagship); the dense CAM is
resized to the attention grid, refined by the PCM and resized back.
Returns (dense, refined), f32. `.train()` runs the heads' BatchNorm on
batch statistics (JAX `_ReshapeHead`, :165). `fused_stack` and the
backbone's options (`**backbone`, DC3D's: kernel sizes, paddings, norm,
activation, dropout, upsampling) go to the backbone only; the tap heads
are the same on both paths. Every at_* option of dram_tpu reaches the
PCM, the positional encoding (at_p_enc_dim, at_geo_f_dim) included.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core import ops
from ..core.resample import resize3d
from .blocks import BatchNorm, Conv1x1
from .pcm import PCM
from .unet3d import DC3D


class _ReshapeHead(nn.Module):
    """1x1x1 conv + BN + ReLU tap head. dram_tpu builds its BatchNorm
    without `axis_name` (dram_tpu/models/dc3d_at.py:165): under data
    parallelism its statistics are local to a rank."""

    def __init__(self, ci, features):
        super().__init__()
        self.conv = Conv1x1(ci, features)
        self.bn = BatchNorm(features, cross_rank=False)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x))).to(x.dtype)


class DC3DATGeneric(nn.Module):
    def __init__(self, n_layers=3,
                 base_ch_list=(32, 64, 128, 256, 256, 128, 64),
                 end_ch_list=(64, 128, 256, 512, 256, 128, 64),
                 out_ch=1, at_spatial_size=(64, 64, 64), at_f_dim=8,
                 at_g_dim=8, at_p_enc_dim=0, at_geo_f_dim=0, at_g_iter=1,
                 at_k_size=3, at_merge_type="scaled_dot_product_relu",
                 at_self_loop=False, at_layers=(-1, 0, 1),
                 at_connectivity=2, stacking=3, dtype=torch.float32,
                 fused_stack=True, pooling_method="avg", **backbone):
        super().__init__()
        self.pooling_method = pooling_method
        self.n_layers = n_layers
        self.at_layers = tuple(at_layers)
        self.at_spatial_size = tuple(at_spatial_size)
        self.dtype = dtype
        self.backbone = DC3D(n_layers, base_ch_list, end_ch_list, out_ch,
                             stacking, dtype=dtype, fused_stack=fused_stack,
                             **backbone)
        # encoder taps see end[idx], the bottleneck end[n], decoder
        # output idx end[n + idx]: one head per tapped layer, in tap order
        # (encoder, bottleneck, decoder: ascending layer index)
        n_us = stacking if 0 <= stacking < n_layers else n_layers
        tap_ch = [end_ch_list[l] for l in sorted(self.at_layers)
                  if 0 <= l <= n_layers + n_us]
        for i, c in enumerate(tap_ch):
            self.add_module(f"reshape_{i}", _ReshapeHead(c, at_f_dim))
        self.reshape_heads = [getattr(self, f"reshape_{i}")
                              for i in range(len(tap_ch))]
        in_ch = (1 if -1 in self.at_layers else 0) + len(tap_ch) * at_f_dim
        self.attention_module = PCM(
            in_ch=in_ch, g_ch=out_ch, f_dim=at_f_dim, geo_f_dim=at_geo_f_dim,
            g_dim=at_g_dim, non_local_iter=at_g_iter, k_size=at_k_size,
            merge_type=at_merge_type, self_loop=at_self_loop,
            connectivity=at_connectivity, p_enc_dim=at_p_enc_dim)

    def set_dropout_generator(self, generator):
        """The torch.Generator the backbone's Dropouts draw from."""
        self.backbone.set_dropout_generator(generator)

    def compute_features(self, x):
        """U-Net trunk + tap heads: (dense logits, PCM input features)."""
        x = x.to(self.dtype).contiguous()
        taps = [x] if -1 in self.at_layers else []
        nc = 0
        bb = self.backbone
        feats, h = bb.encoder(x)
        for idx, f in enumerate(feats):
            if idx in self.at_layers:
                taps.append(self.reshape_heads[nc](f.detach()))
                nc += 1
        xbg = bb.bottleneck(h)
        if self.n_layers in self.at_layers:
            taps.append(self.reshape_heads[nc](xbg.detach()))
            nc += 1
        us_feats = bb.decoder(xbg, feats)
        for idx in range(1, len(us_feats)):
            if self.n_layers + idx in self.at_layers:
                taps.append(self.reshape_heads[nc](us_feats[idx].detach()))
                nc += 1
        dense = bb.top(us_feats[-1], x.shape[1:4])
        taps = [resize3d(t, self.at_spatial_size) for t in taps]
        return dense, torch.cat(taps, dim=-1)

    def apply_attention(self, dense, features):
        cam = resize3d(dense, self.at_spatial_size)
        refined = self.attention_module(cam, features)
        return resize3d(refined, dense.shape[1:4]).float()

    def pooling_dense_features(self, dense_outs, lungs, pooling_method=None):
        return ops.pooling_dense_features(
            dense_outs, lungs, pooling_method or self.pooling_method)

    def forward(self, x):
        """x: (B, D, H, W, 1) -> (dense, refined) f32 logits."""
        dense, features = self.compute_features(x)
        return dense, self.apply_attention(dense, features)

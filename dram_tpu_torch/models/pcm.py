"""PCM: the pixel-correlation refinement as masked stencil attention.

Port of dram_tpu/models/pcm.py for the shipped configuration: merge type
'scaled_dot_product_relu', k = 3, connectivity 2, no self loop, no
positional encoding (p_enc_dim = 0), whole volume (z0 = 0). This is the
JAX package's use_pallas branch (:231-246): theta/phi/G dense layers, the
stencil attention, then the r dense layer, `non_local_iter` times. The
attention is differentiable (window_attention.StencilAttentionFunction),
so the same forward trains. The dense layers run in f32 where dram_tpu
runs them in the compute dtype (bf16 in the flagship).
`stencil_offsets` and `_valid_masks` live beside the kernel in
dram_tpu_torch/kernels/window_attention.py.
"""

from __future__ import annotations

from torch import nn

from ..kernels import window_attention


class PCM(nn.Module):
    def __init__(self, in_ch=17, g_ch=1, f_dim=8, g_dim=8, non_local_iter=1,
                 k_size=3, merge_type="scaled_dot_product_relu",
                 self_loop=False, connectivity=2, residual=False,
                 p_enc_dim=0):
        super().__init__()
        if merge_type != "scaled_dot_product_relu" or p_enc_dim != 0 \
                or f_dim <= 0 or g_dim <= 0:
            raise NotImplementedError(
                f"PCM merge_type={merge_type!r}, p_enc_dim={p_enc_dim}, "
                f"f_dim={f_dim}, g_dim={g_dim}: only the shipped "
                "'scaled_dot_product_relu' with p_enc_dim=0 is ported; the "
                "other merge types are ROADMAP Queue 1")
        self.offsets = window_attention.stencil_offsets(k_size, connectivity,
                                                        self_loop)
        self.non_local_iter = non_local_iter
        self.residual = residual
        self.theta = nn.Linear(in_ch, f_dim)
        self.phi = nn.Linear(in_ch, f_dim)
        self.G = nn.Linear(g_ch, g_dim)
        self.r = nn.Linear(g_dim, g_ch)

    def forward(self, cam, f):
        """cam: (B, D, H, W, g_ch); f: (B, D, H, W, in_ch) -> refined cam,
        all in f32."""
        cam, f = cam.float(), f.float()
        theta = self.theta(f).contiguous()
        phi = self.phi(f).contiguous()
        for _ in range(self.non_local_iter):
            out = window_attention.stencil_attention(
                theta, phi, self.G(cam).contiguous(), self.offsets)
            refined = self.r(out)
            cam = refined + cam if self.residual else refined
        return cam

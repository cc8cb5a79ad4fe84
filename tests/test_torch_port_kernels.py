"""dram_tpu_torch kernel modules (their plain versions, which CPU tensors
take) vs the JAX package's Pallas kernels in interpret mode, on the same
numpy inputs. The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dram_tpu.core.pallas.cm import CM, as_ndhwc, to_cm_t
from dram_tpu.core.pallas.fused_stack import fused_cbr2
from dram_tpu.core.pallas.pool import maxpool2_flat
from dram_tpu.core.pallas.window_attention import stencil_attention as jax_att
from dram_tpu.models.pcm import stencil_offsets as jax_offsets

from dram_tpu_torch.kernels import conv_stack, pool, upsample
from dram_tpu_torch.kernels import window_attention as wa
from dram_tpu_torch.models.blocks import ConvStack

# f32 on both sides: the only differences are summation order and the
# interpolation weights' f32 rounding, ~1e-6 relative on O(1) values
RTOL, ATOL = 1e-5, 2e-5


def _bn(rng, c):
    return (rng.uniform(0.5, 1.5, c).astype(np.float32),
            (rng.normal(size=c) * 0.1).astype(np.float32),
            (rng.normal(size=c) * 0.05).astype(np.float32),
            rng.uniform(0.5, 1.5, c).astype(np.float32))


def _stack(ci, c0, c1, rng):
    w0 = (rng.normal(size=(3, 3, 3, ci, c0)) * 0.2).astype(np.float32)
    w1 = (rng.normal(size=(3, 3, 3, c0, c1)) * 0.2).astype(np.float32)
    return w0, _bn(rng, c0), w1, _bn(rng, c1)


def _port_stack(ci, w0, bn0, w1, bn1):
    # eval: the running-statistics path (a module starts in train mode)
    m = ConvStack(ci, (w0.shape[-1], w1.shape[-1])).eval()
    with torch.no_grad():
        m.conv_0.weight.copy_(torch.from_numpy(w0.transpose(4, 3, 0, 1, 2)))
        m.conv_1.weight.copy_(torch.from_numpy(w1.transpose(4, 3, 0, 1, 2)))
        for bn, (g, b, mu, var) in ((m.BatchNorm_0, bn0),
                                    (m.BatchNorm_1, bn1)):
            bn.weight.copy_(torch.from_numpy(g))
            bn.bias.copy_(torch.from_numpy(b))
            bn.running_mean.copy_(torch.from_numpy(mu))
            bn.running_var.copy_(torch.from_numpy(var))
    return m


def _jax_stack(x, w0, bn0, w1, bn1):
    args = [jnp.asarray(a) for a in (w0, *bn0, w1, *bn1)]
    y, _ = fused_cbr2(x, *args, train=False, interpret=True,
                      cm_out=isinstance(x, tuple))
    return np.asarray(as_ndhwc(y))


class TestConvStack:
    """ConvStack (conv3x3x3 with the folded eval BN + ReLU) vs the fused
    Pallas chain fused_cbr2 at eval, running statistics."""

    @pytest.mark.parametrize("ci", [16, 1], ids=["ci16", "ci1"])
    def test_single_input(self, ci):
        rng = np.random.default_rng(3)
        x = rng.normal(size=(2, 6, 8, 8, ci)).astype(np.float32)
        w0, bn0, w1, bn1 = _stack(ci, 16, 8, rng)
        with torch.no_grad():
            got = _port_stack(ci, w0, bn0, w1, bn1)(torch.from_numpy(x))
        if ci < 8:
            # the JAX ConvStack zero-pads Ci=1 to the TPU's 8-sublane
            # floor (models/blocks.py:235-242); the port takes Ci=1 as is
            x = np.pad(x, [(0, 0)] * 4 + [(0, 8 - ci)])
            w0 = np.pad(w0, [(0, 0)] * 3 + [(0, 8 - ci), (0, 0)])
        want = _jax_stack(jnp.asarray(x), w0, bn0, w1, bn1)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)

    def test_two_part_input(self):
        """The decoder's virtual concat: [up, skip] as two parts."""
        rng = np.random.default_rng(4)
        up = rng.normal(size=(2, 4, 8, 8, 16)).astype(np.float32)
        skip = rng.normal(size=(2, 4, 8, 8, 8)).astype(np.float32)
        w0, bn0, w1, bn1 = _stack(24, 16, 8, rng)
        with torch.no_grad():
            got = _port_stack(24, w0, bn0, w1, bn1)(
                torch.from_numpy(up), torch.from_numpy(skip))
        want = _jax_stack((to_cm_t(jnp.asarray(up)),
                           to_cm_t(jnp.asarray(skip))), w0, bn0, w1, bn1)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)

    def test_plain_two_parts_equal_concat(self):
        rng = np.random.default_rng(5)
        a = torch.from_numpy(rng.normal(size=(1, 4, 5, 6, 3))
                             .astype(np.float32))
        b = torch.from_numpy(rng.normal(size=(1, 4, 5, 6, 2))
                             .astype(np.float32))
        w = torch.from_numpy(rng.normal(size=(4, 5, 3, 3, 3))
                             .astype(np.float32))
        s, t = torch.ones(4), torch.zeros(4)
        torch.testing.assert_close(
            conv_stack.conv3x3x3(a, w, s, t, x2=b),
            conv_stack.conv3x3x3(torch.cat([a, b], -1), w, s, t))


class TestMaxPool2:
    def test_matches_pallas_exactly(self):
        rng = np.random.default_rng(6)
        B, D, H, W, C = 2, 8, 8, 16, 8
        x = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
        x[:, :, ::2] = x[:, :, 1::2]  # ties inside windows
        cm = to_cm_t(jnp.asarray(x))
        want = np.asarray(as_ndhwc(CM(maxpool2_flat(cm.data, H, W, True),
                                      H // 2, W // 2)))
        got = pool.maxpool2(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want)


class TestUpsample2x:
    def test_matches_upsample2x_cm(self, monkeypatch):
        """upsample2x_cm with its Pallas depth pass (interpret) forced on,
        as on the TPU."""
        import dram_tpu.core.pallas.upsample as up_mod
        from dram_tpu.core.pallas.cm import upsample2x_cm
        orig = up_mod.up2_depth_flat
        monkeypatch.setattr(up_mod, "up2_depth_supported",
                            lambda *a, **k: True)
        monkeypatch.setattr(up_mod, "up2_depth_flat",
                            lambda x: orig(x, True))
        rng = np.random.default_rng(7)
        x = rng.normal(size=(2, 5, 4, 6, 8)).astype(np.float32)
        want = np.asarray(as_ndhwc(upsample2x_cm(to_cm_t(jnp.asarray(x)))))
        got = upsample.upsample2x(torch.from_numpy(x)).numpy()
        assert got.shape == (2, 10, 8, 12, 8)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


class TestStencilAttention:
    def test_offsets_match_scipy_structure(self):
        """The port writes the stencil out without scipy: same offsets,
        same order as the JAX package's ndimage-built list."""
        assert wa.stencil_offsets(3, 2, False) == jax_offsets(3, 2, False)
        assert wa.stencil_offsets(3, 1, True) == jax_offsets(3, 1, True)
        assert wa.stencil_offsets(3, 3, False) == jax_offsets(3, 3, False)
        assert len(wa.KERNEL_OFFSETS) == 18

    def test_matches_pallas_interpret(self):
        rng = np.random.default_rng(8)
        shape = (2, 6, 8, 8)
        theta, phi, g = (rng.normal(size=shape + (8,)).astype(np.float32)
                         for _ in range(3))
        offs = jax_offsets(3, 2, False)
        want = np.asarray(jax_att(jnp.asarray(theta), jnp.asarray(phi),
                                  jnp.asarray(g), offs, 4, True))
        got = wa.stencil_attention(torch.from_numpy(theta),
                                   torch.from_numpy(phi),
                                   torch.from_numpy(g)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    def test_other_stencils_take_plain_version(self):
        """A self-loop stencil runs through the plain version on the CPU
        and matches the JAX package's XLA stencil (pcm.py roll+mask)."""
        from dram_tpu.models.pcm import _masked_softmax, _shift, _valid_masks
        rng = np.random.default_rng(9)
        theta, phi, g = (rng.normal(size=(1, 4, 5, 6, 8)).astype(np.float32)
                         for _ in range(3))
        offs = jax_offsets(3, 1, True)
        valid = _valid_masks((4, 5, 6), offs).astype(jnp.float32)
        deg = valid.sum(-1)
        dots = jnp.stack([jnp.sum(theta * _shift(jnp.asarray(phi), o), -1)
                          for o in offs], -1)
        w = _masked_softmax(jax.nn.relu(dots)
                            / jnp.sqrt(jnp.maximum(deg, 1.0))[..., None],
                            valid[None])
        want = sum(w[..., k:k + 1] * _shift(jnp.asarray(g), o)
                   for k, o in enumerate(offs))
        got = wa.stencil_attention(torch.from_numpy(theta),
                                   torch.from_numpy(phi),
                                   torch.from_numpy(g), offs).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


class TestBf16RoundingPoints:
    """The port rounds to bf16 once per kernel (after the f32 epilogue /
    the single trilinear pass); the JAX package rounds between its passes.
    Pins the port's rounding point and bounds the gap on the CPU."""

    def test_conv_rounds_once(self):
        rng = np.random.default_rng(10)
        x = torch.from_numpy(rng.normal(size=(1, 4, 6, 6, 8))
                             .astype(np.float32)).to(torch.bfloat16)
        w = torch.from_numpy(rng.normal(size=(8, 8, 3, 3, 3))
                             .astype(np.float32) * 0.2)
        s, t = torch.rand(8) + 0.5, torch.randn(8) * 0.1
        got = conv_stack.conv3x3x3(x, w, s, t)
        once = conv_stack.conv3x3x3(x.float(), w.to(torch.bfloat16).float(),
                                    s, t).to(torch.bfloat16)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, once, rtol=0, atol=0)

    def test_upsample_rounds_once(self):
        from dram_tpu.core.pallas.cm import upsample2x_cm
        rng = np.random.default_rng(11)
        x = rng.normal(size=(1, 4, 6, 6, 8)).astype(np.float32)
        xb = torch.from_numpy(x).to(torch.bfloat16)
        got = upsample.upsample2x(xb)
        once = upsample.upsample2x(xb.float()).to(torch.bfloat16)
        torch.testing.assert_close(got, once, rtol=0, atol=0)
        # JAX rounds to bf16 after each separable pass (cm.py:253-259)
        xj = jnp.asarray(xb.float().numpy(), jnp.bfloat16)
        want = np.asarray(as_ndhwc(upsample2x_cm(to_cm_t(xj))), np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -6,
                                   atol=2 ** -6)

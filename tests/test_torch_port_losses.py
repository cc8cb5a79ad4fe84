"""dram_tpu_torch losses and their masked reductions vs the JAX package on
the CPU: the same numpy inputs through both, values and input gradients
(jax.value_and_grad against torch autograd) in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dram_tpu.core import ops as jops
from dram_tpu.losses import bootstrap_bce as jbce
from dram_tpu.losses import interval_reg as jir
from dram_tpu.losses import refine as jref

from dram_tpu_torch.core import ops
from dram_tpu_torch.losses import bootstrap_bce, interval_reg, refine

# f32 on both sides; the only differences are the order of the sums,
# whose error scales with the largest term (hence the gradients' atol)
RTOL, ATOL = 1e-5, 1e-7
SHAPE = (2, 16, 16, 16, 1)


def _close_grad(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def _inputs(seed, ctss=(3, 0)):
    rng = np.random.default_rng(seed)
    dense = rng.normal(0.0, 2.0, SHAPE).astype(np.float32)
    lobes = (rng.uniform(size=SHAPE) > 0.3).astype(np.float32)
    lesions = (rng.uniform(size=SHAPE) > 0.8).astype(np.float32)
    freq = np.array([0.3, 0.05, 0.23, 0.9, 0.18, 0.15], np.float32)
    return dense, lobes, lesions, np.asarray(ctss, np.int32), freq


def _jax_terms(loss, dense, lobes, lesions, ctss, freq, sw):
    def terms(d):
        return loss(lambda im, lo: (d, d), None, jnp.asarray(lobes),
                    jnp.asarray(lesions), jnp.asarray(ctss),
                    ctss_frequency=jnp.asarray(freq),
                    sample_weight=None if sw is None else jnp.asarray(sw))
    out = []
    for k in range(2):
        v, g = jax.value_and_grad(lambda d: terms(d)[k])(jnp.asarray(dense))
        out.append((float(v), np.asarray(g)))
    return out


def _torch_terms(loss, dense, lobes, lesions, ctss, freq, sw):
    out = []
    for k in range(2):
        d = torch.from_numpy(dense).requires_grad_()
        v = loss(lambda im, lo: (d, d), None, torch.from_numpy(lobes),
                 torch.from_numpy(lesions), torch.from_numpy(ctss),
                 ctss_frequency=freq,
                 sample_weight=None if sw is None else torch.from_numpy(sw))[k]
        v.backward()
        out.append((float(v.detach()), d.grad.numpy()))
    return out


class TestLosses:
    @pytest.mark.parametrize("name", ["IntRegLoss", "IntRegRefineLoss"])
    @pytest.mark.parametrize("weighted", [False, True],
                             ids=["unweighted", "row_weights"])
    def test_values_and_input_grads(self, name, weighted):
        dense, lobes, lesions, ctss, freq = _inputs(0)
        sw = np.array([1.0, 0.0], np.float32) if weighted else None
        if name == "IntRegLoss":
            jl, tl = jir.IntRegLoss(5e-2), interval_reg.IntRegLoss(5e-2)
        else:
            jl = jref.IntRegRefineLoss(band_width=1e-2, smoothing=0.1)
            tl = refine.IntRegRefineLoss(band_width=1e-2, smoothing=0.1)
        want = _jax_terms(jl, dense, lobes, lesions, ctss, freq, sw)
        got = _torch_terms(tl, dense, lobes, lesions, ctss, freq, sw)
        for (wv, wg), (gv, gg) in zip(want, got):
            assert gv == pytest.approx(wv, rel=RTOL, abs=ATOL)
            _close_grad(gg, wg)

    def test_reg_loss_is_nonzero_here(self):
        """The inputs above leave the score interval, so the hinge and
        its gradient are exercised, not just the zero branch."""
        dense, lobes, lesions, ctss, freq = _inputs(0)
        v = interval_reg.compute_reg_loss_with_probs(
            torch.sigmoid(torch.from_numpy(dense)), torch.from_numpy(lobes),
            torch.from_numpy(lesions), torch.from_numpy(ctss), 1e-2, freq)
        assert float(v) > 1e-3

    @pytest.mark.parametrize("weighted", [False, True])
    def test_boot_bce(self, weighted):
        rng = np.random.default_rng(1)
        p = rng.uniform(0.01, 0.99, SHAPE).astype(np.float32)
        t = (rng.uniform(size=SHAPE) > 0.6).astype(np.float32)
        voi = (rng.uniform(size=SHAPE) > 0.4).astype(np.float32)
        sw = np.array([0.0, 1.0], np.float32) if weighted else None

        def jf(pp):
            return jbce.BootBinCrossEntropy(0.1)(
                pp, jnp.asarray(t), jnp.asarray(voi),
                sample_weight=None if sw is None else jnp.asarray(sw))
        wv, wg = jax.value_and_grad(jf)(jnp.asarray(p))
        pt = torch.from_numpy(p).requires_grad_()
        gv = bootstrap_bce.BootBinCrossEntropy(0.1)(
            pt, torch.from_numpy(t), torch.from_numpy(voi),
            sample_weight=None if sw is None else torch.from_numpy(sw))
        gv.backward()
        assert float(gv.detach()) == pytest.approx(float(wv), rel=RTOL)
        _close_grad(pt.grad.numpy(), np.asarray(wg))

    def test_boot_bce_empty_region(self):
        """No voxel inside the region: only the outside term remains."""
        shape = (2, 4, 4, 4, 1)
        p = np.random.default_rng(6).uniform(0.1, 0.9, shape) \
            .astype(np.float32)
        t = np.zeros(shape, np.float32)
        voi = np.zeros(shape, np.float32)
        want = float(jbce.BootBinCrossEntropy(0.1)(
            jnp.asarray(p), jnp.asarray(t), jnp.asarray(voi)))
        got = float(bootstrap_bce.BootBinCrossEntropy(0.1)(
            torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(voi)))
        assert got == pytest.approx(want, rel=RTOL)
        assert got == pytest.approx(float(-np.log(1.0 - p.astype(np.float64))
                                          .mean()), rel=RTOL)

    def test_bce_smooth(self):
        rng = np.random.default_rng(2)
        p = rng.uniform(0, 1, (3, 50)).astype(np.float32)
        t = (rng.uniform(size=(3, 50)) > 0.5).astype(np.float32)
        want = float(jbce.BinaryCrossEntropySmooth(0.9)(jnp.asarray(p),
                                                        jnp.asarray(t)))
        got = float(bootstrap_bce.BinaryCrossEntropySmooth(0.9)(
            torch.from_numpy(p), torch.from_numpy(t)))
        assert got == pytest.approx(want, rel=RTOL)


class TestIntervals:
    def test_get_labels_four_branches(self):
        """Intersection non-empty; band below the interval (empty, the
        band wins); band above (empty, the interval wins); a band clipped
        at 0 and at 1."""
        ctss = np.array([3, 4, 1, 0, 5], np.int32)
        ps = np.array([0.2, 0.1, 0.4, 0.004, 0.999], np.float32)
        want = np.asarray(jir.get_labels(jnp.asarray(ctss), jnp.asarray(ps),
                                         1e-2))
        got = interval_reg.get_labels(torch.from_numpy(ctss),
                                      torch.from_numpy(ps), 1e-2).numpy()
        np.testing.assert_array_equal(got, want)
        # the branches really differ: intersection, band, interval
        np.testing.assert_allclose(got[0], [0.19, 0.21], rtol=1e-6)
        np.testing.assert_allclose(got[1], [0.09, 0.11], rtol=1e-6)
        np.testing.assert_allclose(got[2], [0.001, 0.01], rtol=1e-6)

    def test_ratio_to_label(self):
        r = [0.0, 0.0005, 0.001, 0.03, 0.2, 0.4, 0.7, 1.5]
        assert interval_reg.ratio_to_label(r) == jir.ratio_to_label(r)

    def test_constants(self):
        np.testing.assert_array_equal(interval_reg.CTSS_RATIO_LB,
                                      jir.CTSS_RATIO_LB)
        np.testing.assert_array_equal(interval_reg.CTSS_RATIO_UB,
                                      jir.CTSS_RATIO_UB)
        np.testing.assert_array_equal(interval_reg.DEFAULT_CTSS_FREQUENCY,
                                      jir.DEFAULT_CTSS_FREQUENCY)

    def test_pseudo_labels_exact(self):
        dense, lobes, lesions, _, _ = _inputs(3)
        ctss = np.array([0, 2], np.int32)
        want = np.asarray(jref.pseudo_labels(
            jnp.asarray(dense), jnp.asarray(lobes), jnp.asarray(lesions),
            jnp.asarray(ctss)))
        d = torch.from_numpy(dense).requires_grad_()
        got = refine.pseudo_labels(d, torch.from_numpy(lobes),
                                   torch.from_numpy(lesions),
                                   torch.from_numpy(ctss))
        assert not got.requires_grad
        np.testing.assert_array_equal(got.numpy(), want)
        assert want[1].sum() > 0 and want[0].sum() == 0

    @pytest.mark.parametrize("weighted", [False, True])
    def test_enc_loss(self, weighted):
        rng = np.random.default_rng(4)
        p = rng.uniform(0, 1, SHAPE).astype(np.float32)
        sw = np.array([1.0, 0.0], np.float32) if weighted else None
        want = float(jir.compute_enc_loss(
            jnp.asarray(p), None if sw is None else jnp.asarray(sw)))
        got = float(interval_reg.compute_enc_loss(
            torch.from_numpy(p), None if sw is None else torch.from_numpy(sw)))
        assert got == pytest.approx(want, rel=RTOL)


class TestOps:
    def test_masked_mean_and_gsum(self):
        rng = np.random.default_rng(5)
        x = rng.normal(size=(3, 4, 5)).astype(np.float32)
        m = (rng.uniform(size=(3, 4, 5)) > 0.5).astype(np.float32)
        m[1] = 0.0  # an empty mask divides by the 1e-12 floor
        want = np.asarray(jops.masked_mean(jnp.asarray(x), jnp.asarray(m),
                                           (1, 2)))
        got = ops.masked_mean(torch.from_numpy(x), torch.from_numpy(m),
                              (1, 2)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        assert float(ops.gsum(torch.from_numpy(x))) == pytest.approx(
            float(jops.gsum(jnp.asarray(x))), rel=RTOL)

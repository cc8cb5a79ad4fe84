"""dram_tpu_torch models, resample and ops vs the JAX package on the CPU,
same numpy inputs and weights (weights carried by
dram_tpu_torch.weights.from_jax)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dram_tpu.core import ops as jops
from dram_tpu.core import resample as jres
from dram_tpu.models import DC3D as JaxDC3D
from dram_tpu.models import DC3DATGeneric as JaxDC3DATGeneric

from dram_tpu_torch import weights
from dram_tpu_torch.core import ops, resample
from dram_tpu_torch.models import DC3D, DC3DATGeneric

NARROW = dict(base_ch_list=(4, 8, 8, 16, 16, 8, 8),
              end_ch_list=(8, 8, 16, 16, 16, 8, 8))
AT = dict(at_spatial_size=(16, 16, 16), at_f_dim=4, at_g_dim=4)


def _perturbed(variables, seed):
    """Init weights with non-trivial BN statistics and affine."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a, np.float32)
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return (rng.normal(size=a.shape) * 0.1).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(f, variables)


class TestModels:
    def test_dc3dat_narrow_32(self):
        """Dense and refined heads at narrow widths, 32^3, f32 on both
        sides; 2e-4 is the bar of tests/test_reference_parity.py at 32^3."""
        rng = np.random.default_rng(1)
        x = rng.uniform(0, 1, size=(2, 32, 32, 32, 1)).astype(np.float32)
        jm = JaxDC3DATGeneric(train=False, **NARROW, **AT)
        v = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                      jnp.asarray(x[:1])), 2)
        jd, jr = jax.jit(jm.apply)(v, jnp.asarray(x))
        m = weights.load_into(DC3DATGeneric(**NARROW, **AT),
                              v["params"], v["batch_stats"]).eval()
        with torch.no_grad():
            d, r = m(torch.from_numpy(x))
        assert d.shape == r.shape == (2, 32, 32, 32, 1)
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=2e-4,
                                   rtol=1e-3)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=2e-4,
                                   rtol=1e-3)

    @pytest.mark.parametrize("stacking", [0, 2])
    def test_dc3d_early_exit(self, stacking):
        """DC3D with an early decoder exit (top layer on a mid decoder
        level) and odd input size (crop of the skip)."""
        rng = np.random.default_rng(3)
        x = rng.normal(size=(1, 18, 16, 20, 1)).astype(np.float32)
        cfg = dict(n_layers=2, base_ch_list=(4, 8, 8, 8, 4),
                   end_ch_list=(8, 8, 16, 8, 8), stacking=stacking)
        jm = JaxDC3D(train=False, **cfg)
        v = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(1),
                                      jnp.asarray(x)), 4)
        jd, _ = jax.jit(jm.apply)(v, jnp.asarray(x))
        m = weights.load_into(DC3D(**cfg), v["params"],
                              v["batch_stats"]).eval()
        with torch.no_grad():
            d, _ = m(torch.from_numpy(x))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=2e-4,
                                   rtol=1e-3)


class TestResample:
    @pytest.mark.parametrize("shape,out", [((5, 6, 7, 3), (8, 4, 7)),
                                           ((2, 4, 4, 4, 2), (9, 1, 5))])
    def test_resize3d(self, shape, out):
        x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
        want = np.asarray(jres.resize3d(jnp.asarray(x), out))
        got = resample.resize3d(torch.from_numpy(x), out).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("method", ["linear", "nearest"])
    def test_itk_resample_np_bit_identical(self, method):
        x = np.random.default_rng(6).integers(
            -1000, 400, (11, 13, 9)).astype(np.float32)
        args = ((17, 10, 12), [0.7, 1.3, 0.75], method, -2048.0)
        np.testing.assert_array_equal(resample.itk_resample3d_np(x, *args),
                                      jres.itk_resample3d_np(x, *args))


class TestOps:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_cam_threshold_same_bin(self, seed):
        rng = np.random.default_rng(seed)
        v = np.clip(np.concatenate([rng.normal(0.2, 0.1, 3000),
                                    rng.normal(0.7, 0.1, 1000)]), 0, 1)
        v = v.astype(np.float32).reshape(10, 20, 20)
        mask = rng.uniform(size=v.shape) > 0.3
        want = float(jops.binary_cam_threshold(jnp.asarray(v),
                                               mask=jnp.asarray(mask)))
        got = float(ops.binary_cam_threshold(torch.from_numpy(v),
                                             torch.from_numpy(mask)))
        assert got == want

    def test_otsu_degenerate(self):
        v = torch.full((4, 4), 100.0)
        assert float(ops.otsu_threshold_u8(v)) == 100.0
        assert float(ops.otsu_threshold_u8(
            v, torch.zeros(4, 4, dtype=torch.bool))) == 255.0
        assert float(jops.otsu_threshold_u8(
            jnp.full((4, 4), 100.0), jnp.zeros((4, 4), bool))) == 255.0

    def test_packbits_round_trip(self):
        m = np.random.default_rng(7).uniform(size=(3, 7, 9)) > 0.4
        packed = ops.packbits_u8(torch.from_numpy(m))
        np.testing.assert_array_equal(packed.numpy(), np.packbits(m))
        np.testing.assert_array_equal(
            np.asarray(jops.packbits_u8(jnp.asarray(m))), packed.numpy())
        np.testing.assert_array_equal(
            ops.unpackbits_u8_dev(packed, m.shape).numpy(), m)
        np.testing.assert_array_equal(ops.unpackbits_np(packed.numpy(),
                                                        m.shape), m)

    def test_otsu_np_matches(self):
        v = np.random.default_rng(8).integers(20, 200, 5000).astype(np.uint8)
        assert ops.otsu_threshold_u8_np(v) == jops.otsu_threshold_u8_np(v)

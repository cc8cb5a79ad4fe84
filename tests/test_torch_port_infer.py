"""dram_tpu_torch.infer.fast vs dram_tpu.infer.fast on small synthetic
scans: the NumPy host prep (prep="numpy") bit for bit, and the whole chunk-wire slice
(prep -> pre -> model -> post) at mask Dice >= 0.995 with the same Otsu
bin, for both values of want_heatmap."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dram_tpu.native
from dram_tpu.data.prepare_data import _synth_scan
from dram_tpu.infer import fast as jfast
from dram_tpu.models import DC3DATGeneric as JaxDC3DATGeneric

from dram_tpu_torch import weights
from dram_tpu_torch.data.synth import synth_scan
from dram_tpu_torch.infer import fast
from dram_tpu_torch.models import DC3DATGeneric

SPAN = (-1000, -700)
CHUNK = (16, 16, 16)
NARROW = dict(base_ch_list=(4, 8, 8, 16, 16, 8, 8),
              end_ch_list=(8, 8, 16, 16, 16, 8, 8),
              at_spatial_size=(8, 8, 8), at_f_dim=4, at_g_dim=4)


@pytest.fixture
def numpy_prep(monkeypatch):
    """The JAX package's prep with its C++ host kernels unavailable, so
    dram_tpu.data.hostprep.prep_scan takes its NumPy branch (the one the
    port copies; the C++ resample rounds +-1 HU differently)."""
    monkeypatch.setattr(dram_tpu.native, "hostprep_native", None,
                        raising=False)


def _scan(seed, size, **kw):
    rng = np.random.default_rng(seed)
    scan, lobe, _, vessel, _ = synth_scan(rng, size, **kw)
    return scan, lobe, vessel


def test_synth_scan_matches_jax():
    got = synth_scan(np.random.default_rng(3), (24, 30, 28))
    want = _synth_scan(np.random.default_rng(3), (24, 30, 28))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["aniso_vessel", "empty_lobe"])
def test_prep_bit_identical(numpy_prep, case):
    scan, lobe, vessel = _scan(5, (30, 40, 36),
                               lesion_severity=[3, 4, 2, 5, 3])
    spacing = (1.6, 0.8, 0.9)
    if case == "empty_lobe":
        lobe[lobe == 4] = 0
        vessel, spacing = None, (1.0, 1.0, 1.0)
    args = (scan, lobe, spacing, 1.0, -2048, vessel, SPAN, CHUNK, 5, 5.0)
    want = jfast._prep_scan_chunks_np(*args)
    got = fast.prep_scan_chunks(*args, prep="numpy")
    for k in ("x80_bits", "lobe_bits", "cand_bits", "starts", "present",
              "offsets", "sizes", "crop_lo"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("bucket", "iso_shape", "out_shape", "spacing", "iso_spacing",
              "intensity_threshold"):
        assert got[k] == want[k], k
    for i in range(3):
        for ax in range(3):
            np.testing.assert_array_equal(got["fw"][i][ax], want["fw"][i][ax])
            np.testing.assert_array_equal(got["bw"][i][ax], want["bw"][i][ax])


@pytest.fixture(scope="module")
def models():
    """The narrow flagship structure with shared random weights (non-
    trivial BN statistics), JAX and port."""
    jm = JaxDC3DATGeneric(train=False, **NARROW)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, *CHUNK, 1)))
    rng = np.random.default_rng(0)

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if path[-1].key == "mean":
            return (rng.normal(size=a.shape) * 0.1).astype(np.float32)
        return a
    v = jax.tree_util.tree_map_with_path(perturb, v)
    pm = weights.load_into(DC3DATGeneric(**NARROW), v["params"],
                           v["batch_stats"])
    return jm, v, pm


def _dice(a, b):
    a, b = a > 0, b > 0
    den = a.sum() + b.sum()
    return 1.0 if den == 0 else 2.0 * np.logical_and(a, b).sum() / den


@pytest.mark.parametrize("want_heatmap", [False, True])
def test_whole_slice_matches_jax(models, want_heatmap):
    jm, v, pm = models
    scan, lobe, vessel = _scan(11, (40, 48, 44),
                               lesion_severity=[3, 4, 2, 5, 3])
    prepc = fast.prep_scan_chunks(scan, lobe, (1.5, 0.9, 0.9),
                                  vessel_u8=vessel, windowing_span=SPAN,
                                  chunk_size=CHUNK)
    want = jfast.FastScanPipeline(jm, v["params"], v["batch_stats"],
                                  chunk_size=CHUNK, windowing_span=SPAN) \
        .process_chunks(dict(prepc), want_heatmap=want_heatmap)
    got = fast.FastScanPipeline(pm, device="cpu") \
        .process_chunks(prepc, want_heatmap=want_heatmap)
    assert got["pred"].shape == scan.shape
    assert got["pred"].any() and got["post"].any()
    # same Otsu bin
    assert round(got["threshold"] * 255) == round(want["threshold"] * 255)
    for k in ("pred", "post"):
        assert _dice(got[k], want[k]) >= 0.995, k
    np.testing.assert_allclose(got["ratios"], np.asarray(want["ratios"]),
                               atol=1e-5)
    if want_heatmap:
        assert np.abs(got["heatmap_u8"].astype(int)
                      - want["heatmap_u8"].astype(int)).max() <= 1


def test_cuda_request_without_gpu_raises(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fast.FastScanPipeline(models[2], device="cuda")

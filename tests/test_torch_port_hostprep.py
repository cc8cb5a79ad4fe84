"""The port's C++ host prep (dram_tpu_torch.native, data.hostprep.prep_scan,
infer.fast.prep_scan_chunks) bit for bit against dram_tpu's on the CPU,
and the scan wires of FastScanPipeline (process_prepped on p12 and w8,
process from a raw scan) against dram_tpu's pipeline on the same weights.

Both libraries are built from the same source with the same flags on this
host, so every output of the prep must be equal bit for bit. The
pipelines are held at the repo's mask gate (Dice >= 0.995, the same Otsu
bin) and the ratios within 2e-4 at 32^3 (tests/test_reference_parity.py's
torch-vs-flax tolerance), heatmaps within one u8 level. OpenMP runs one
thread a library here: the tier-1 run has six workers.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dram_tpu.native
from dram_tpu.data import hostprep as jhostprep
from dram_tpu.infer import fast as jfast
from dram_tpu.models import DC3DATGeneric as JaxDC3DATGeneric
from dram_tpu.native import hostprep_native as jnat

from dram_tpu_torch import native, weights
from dram_tpu_torch.data import hostprep
from dram_tpu_torch.data.synth import synth_scan
from dram_tpu_torch.infer import fast
from dram_tpu_torch.models import DC3DATGeneric
from dram_tpu_torch.native import hostprep_native as nat

from test_torch_port_infer import CHUNK, NARROW, SPAN

SPACING = (1.6, 0.8, 0.9)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Both libraries built at once (two g++ processes), then one OpenMP
    thread (one libgomp serves both) and one torch thread."""
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(native.load),
                  pool.submit(dram_tpu.native._lib)]:
            f.result()
    native.set_num_threads(1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scan(seed, size, **kw):
    scan, lobe, _, vessel, _ = synth_scan(np.random.default_rng(seed), size,
                                          **kw)
    return scan, lobe, vessel


def _window_args(rng):
    scan = rng.integers(-2400, 2400, (20, 26, 24)).astype(np.int16)
    lobe = rng.integers(0, 6, scan.shape).astype(np.uint8)
    lo, shape = (3, 2, 5), (16, 12, 10)
    return scan, lobe, lo, shape


# one call per wrapper on seeded inputs: (name, args) of hostprep_native
def _cases(rng):
    scan, lobe, lo, shape = _window_args(rng)
    lobe_c = nat.resample_window_labels(lobe, SPACING, 1.0, lo, shape)
    w8, _ = nat.window8_hist(scan, lobe, SPAN)
    bits = rng.integers(0, 256, 40).astype(np.uint8)
    tables = [np.array([0, 2, 3, 3, 7], np.int32),
              np.array([1, 1, 4, 5], np.int32),
              np.array([0, 6, 2], np.int32)]
    return {
        "resample_iso_int16": (scan, SPACING, 1.0, -2048),
        "resample_window_int16": (scan, SPACING, 1.0, lo, shape, -1500),
        "resample_window_w8hist": (scan, SPACING, 1.0, lo, shape, lobe_c,
                                   SPAN, -2048),
        "subgrid_bboxes": (lobe, SPACING, 0.7, 5),
        "resample_window_labels": (lobe, SPACING, 1.0, lo, shape),
        "resample_iso_labels": (lobe, SPACING, 1.2),
        "resample_scales_f32": (scan.astype(np.float32) / 7, (1.3, 0.6, 0.9),
                                (15, 40, 27), -5.0),
        "resample_scales_u8_nearest": (lobe, (1.3, 0.6, 0.9), (15, 40, 27)),
        "pack12": (scan[:, :, :7],),
        "pack4": (lobe[:, :, :7],),
        "lobe_bboxes": (np.where(lobe == 3, 0, lobe), 5),
        "extract_chunk_w8": (scan, lobe, 2, (1, 2, 3), (15, 20, 17), SPAN,
                             (16, 12, 8)),
        "extract_chunk_bf16": (scan, lobe, 4, (4, 0, 2), (9, 26, 20), SPAN,
                               (16, 16, 16)),
        "window8_hist": (scan, lobe, SPAN),
        "cand_bits": (w8, (lobe == 1).astype(np.uint8), 77.25),
        "lobe_bucket_bits": (lobe, np.array([[0, 0, 0], [2, 3, 4],
                                             [4, 10, 8], [1, 1, 1],
                                             [0, 6, 0]], np.int32),
                             (16, 16, 16), 5),
        "crop_copy": (lobe, lo, shape),
        "unpackbits": (bits, (5, 8, 7)),
        "unpack_nearest_gather": (bits, (8, 8, 5), (11, 9, 6), (3, 2, 1),
                                  (5, 4, 3), tables),
    }


WRAPPERS = ("crop_copy", "extract_chunk_bf16", "extract_chunk_w8",
            "lobe_bboxes", "lobe_bucket_bits", "pack12", "pack4",
            "resample_iso_int16", "resample_iso_labels",
            "resample_scales_f32", "resample_scales_u8_nearest",
            "resample_window_int16", "resample_window_labels",
            "resample_window_w8hist", "subgrid_bboxes", "unpack_nearest_gather",
            "unpackbits", "window8_hist", "cand_bits")


def _flat(out):
    if isinstance(out, tuple):
        return [a for o in out for a in _flat(o)]
    return [np.asarray(out)]


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_bitwise(name):
    """Every hostprep_native wrapper against dram_tpu's on seeded inputs,
    every output bit for bit (dtype and shape included)."""
    args = _cases(np.random.default_rng(7))[name]
    if name == "unpack_nearest_gather":
        got, want = (fn(*args[:2], np.zeros(args[2], np.uint8), *args[3:])
                     for fn in (nat.unpack_nearest_gather,
                                jnat.unpack_nearest_gather))
        assert got.any()
    else:
        got, want = getattr(nat, name)(*args), getattr(jnat, name)(*args)
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_every_entry_point_is_bound():
    """The port binds every extern "C" function of its hostprep.cpp, and
    the wrapper cases above cover every public wrapper."""
    import re
    with open(native.SRC) as fp:
        src = fp.read()
    body = src[src.index('extern "C" {'):]
    defined = set(re.findall(r"^void (\w+)\(", body, re.M))
    assert defined == set(native.SIGNATURES)
    public = {k for k in vars(native.hostprep_native) if not k.startswith("_")}
    assert public == set(WRAPPERS) == set(_cases(np.random.default_rng(0)))


PREP_KEYS = ("packed_scan", "packed_lobe", "iso_lobe_host",
             "iso_vessel_host", "crop_lo")
GEOMETRY = ("wire", "windowing_span", "iso_shape", "n_voxels",
            "full_iso_shape", "spacing", "iso_spacing", "out_shape")


@pytest.mark.parametrize("case", ["p12", "p12_vessel", "w8", "w8_vessel",
                                  "empty_lung"])
def test_prep_scan_bitwise(case):
    """prep_scan on both wires, with and without vessels and with an
    empty lung, against dram_tpu's (its native crop-window branch): every
    wire array and geometry key equal; the port's own keys hold the
    clipped iso scan and the labels."""
    scan, lobe, vessel = _scan(3, (30, 40, 36),
                               lesion_severity=[3, 4, 2, 5, 3])
    scan[0, 0, :4] = (-3024, 3071, -2049, 2048)
    span = SPAN if case.startswith("w8") else None
    if case == "empty_lung":
        lobe[:] = 0
    if not case.endswith("vessel"):
        vessel = None
    kw = dict(iso_spacing=1.0, pad_value=-2048, vessel_u8=vessel,
              windowing_span=span)
    want = jhostprep.prep_scan(scan, lobe, SPACING, **kw)
    got = hostprep.prep_scan(scan, lobe, SPACING, **kw)
    for k in PREP_KEYS:
        if want[k] is None:
            assert got[k] is None, k
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in GEOMETRY:
        assert got[k] == want[k], k
    assert got["wire"] == ("w8" if span else "p12")
    iso = hostprep.unpack12_np(*hostprep.pack12(got["iso_scan"]))
    np.testing.assert_array_equal(got["iso_scan"].reshape(-1), iso)
    assert got["iso_scan"].min() >= -2048 and got["iso_scan"].max() <= 2047
    assert got["iso_lobe"] is got["iso_lobe_host"]
    if case == "empty_lung":
        assert got["iso_shape"] == got["full_iso_shape"]


def test_numpy_prep_scan_matches_jax_numpy_branch(monkeypatch):
    """prep="numpy" is dram_tpu's NumPy branch (its C++ switched off), bit
    for bit, on both wires; the NumPy pack12 / pack4 round-trip."""
    monkeypatch.setattr(dram_tpu.native, "hostprep_native", None)
    scan, lobe, vessel = _scan(4, (24, 34, 30))
    for span in (None, SPAN):
        want = jhostprep.prep_scan(scan, lobe, SPACING, vessel_u8=vessel,
                                   windowing_span=span)
        got = hostprep.prep_scan(scan, lobe, SPACING, vessel_u8=vessel,
                                 windowing_span=span, prep="numpy")
        for k in PREP_KEYS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in GEOMETRY:
            assert got[k] == want[k], k
    labels = np.arange(11, dtype=np.uint8) % 6
    np.testing.assert_array_equal(
        hostprep.unpack4_np(*hostprep.pack4(labels)), labels)
    np.testing.assert_array_equal(hostprep.pack4(labels)[0],
                                  nat.pack4(labels)[0])


@pytest.mark.parametrize("case", ["aniso_vessel", "empty_lobe"])
def test_prep_scan_chunks_native_bitwise(case):
    """The native chunk prep against dram_tpu's _prep_scan_chunks_native:
    chunk, lobe and candidate bits, tables and geometry equal."""
    scan, lobe, vessel = _scan(5, (30, 40, 36),
                               lesion_severity=[3, 4, 2, 5, 3])
    spacing = (1.6, 0.8, 0.9)
    if case == "empty_lobe":
        lobe[lobe == 4] = 0
        vessel, spacing = None, (1.0, 1.0, 1.0)
    args = (scan, lobe, spacing, 1.0, -2048, vessel, SPAN, CHUNK, 5, 5.0)
    want = jfast._prep_scan_chunks_native(*args)
    got = fast.prep_scan_chunks(*args)
    for k in ("x80_bits", "lobe_bits", "cand_bits", "starts", "present",
              "offsets", "sizes", "crop_lo"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("bucket", "iso_shape", "out_shape", "spacing", "iso_spacing",
              "intensity_threshold", "wire"):
        assert got[k] == want[k], k
    for i in range(3):
        for ax in range(3):
            np.testing.assert_array_equal(got["fw"][i][ax], want["fw"][i][ax])
            np.testing.assert_array_equal(got["bw"][i][ax], want["bw"][i][ax])


# --- the scan wires against dram_tpu's pipeline ----------------------------
#
# scan (20, 40, 35) at SPACING has an iso grid of 32^3 whose lung window is
# the whole grid, so the three paths share dram_tpu's stage-2 program.


@pytest.fixture(scope="module")
def models():
    """test_torch_port_infer.py's narrow flagship structure with seeded
    numpy weights (kernels at He scale, BatchNorm scales and running
    variances in [0.5, 1.5], biases and running means at 0.1 scale), set
    in the port's model and mapped to dram_tpu's tree by weights.to_jax:
    no JAX init to compile."""
    pm = DC3DATGeneric(**NARROW).eval()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, t in pm.state_dict().items():
            if name.endswith("running_var") or (
                    t.ndim == 1 and name.endswith("weight")):
                a = rng.uniform(0.5, 1.5, t.shape)
            elif t.ndim == 1:
                a = rng.normal(size=t.shape) * 0.1
            else:
                a = rng.normal(size=t.shape) * np.sqrt(2.0 / t[0].numel())
            t.copy_(torch.from_numpy(a))
    params, batch_stats = weights.to_jax(pm.state_dict())
    return JaxDC3DATGeneric(train=False, **NARROW), \
        {"params": params, "batch_stats": batch_stats}, pm


@pytest.fixture(scope="module")
def wires(models):
    jm, v, pm = models
    scan, lobe, vessel = _scan(11, (20, 40, 35),
                               lesion_severity=[3, 4, 2, 5, 3])
    jpipe = jfast.FastScanPipeline(jm, v["params"], v["batch_stats"],
                                   chunk_size=CHUNK, windowing_span=SPAN)
    ppipe = fast.FastScanPipeline(pm, device="cpu", chunk_size=CHUNK,
                                  windowing_span=SPAN)
    runs = {}
    for wire, span in (("p12", None), ("w8", SPAN)):
        want_prep = jhostprep.prep_scan(scan, lobe, SPACING, vessel_u8=vessel,
                                        windowing_span=span)
        got_prep = hostprep.prep_scan(scan, lobe, SPACING, vessel_u8=vessel,
                                      windowing_span=span)
        assert got_prep["iso_shape"] == (32, 32, 32)
        runs[wire] = (jpipe.process_prepped(want_prep, want_heatmap=True),
                      ppipe.process_prepped(got_prep, want_heatmap=True))
    iso_vessel = hostprep.prep_scan(scan, lobe, SPACING,
                                    vessel_u8=vessel)["iso_vessel"]
    runs["device"] = (jpipe.process(scan, lobe, SPACING,
                                    vessel_np=iso_vessel),
                      ppipe.process(scan, lobe, SPACING,
                                    vessel_np=iso_vessel))
    return scan, lobe, vessel, ppipe, runs


def _dice(a, b):
    a, b = a > 0, b > 0
    den = a.sum() + b.sum()
    return 1.0 if den == 0 else 2.0 * np.logical_and(a, b).sum() / den


@pytest.mark.parametrize("wire", ["p12", "w8", "device"])
def test_scan_wire_matches_jax(wires, wire):
    """process_prepped (p12, w8) and process against dram_tpu's on the
    same scan and weights: masks at Dice >= 0.995 and the same Otsu bin,
    ratios within 2e-4, heatmaps within one u8 level."""
    scan = wires[0]
    want, got = wires[4][wire]
    assert got["pred"].shape == scan.shape and got["pred"].any()
    assert got["post"].any()
    assert round(got["threshold"] * 255) == round(want["threshold"] * 255)
    for k in ("pred", "post"):
        assert _dice(got[k], want[k]) >= 0.995, k
    np.testing.assert_allclose(got["ratios"], np.asarray(want["ratios"]),
                               atol=2e-4)
    np.testing.assert_array_equal(got["present"], np.ones(5))
    if wire != "device":
        assert got["out_window"] == want["out_window"]
        assert np.abs(got["heatmap_u8"].astype(int)
                      - want["heatmap_u8"].astype(int)).max() <= 1
    assert set(got["stage_ms"]) == {"pre", "model", "post"}


def test_wires_agree(wires):
    """The repo's own gates between the port's wires: w8 against p12 at
    Dice > 0.98 and ratios within 5e-3 (tests/test_fast_infer.py), p12
    against the chunk wire of the same C++ resample at Dice >= 0.995."""
    scan, lobe, vessel, ppipe, runs = wires
    p12, w8 = runs["p12"][1], runs["w8"][1]
    assert _dice(w8["pred"], p12["pred"]) > 0.98
    np.testing.assert_allclose(w8["ratios"], p12["ratios"], atol=5e-3)
    prepc = fast.prep_scan_chunks(scan, lobe, SPACING, vessel_u8=vessel,
                                  windowing_span=SPAN, chunk_size=CHUNK)
    wc = ppipe.process_chunks(prepc, want_heatmap=True)
    for k in ("pred", "post"):
        assert _dice(p12[k], wc[k]) >= 0.995, k
    assert round(p12["threshold"] * 255) == round(wc["threshold"] * 255)


def test_unpack_false_returns_device_values(wires):
    """unpack=False on the three wires returns the packed masks and the
    threshold and ratios as tensors, equal to the unpacked run's."""
    scan, lobe, vessel, ppipe, runs = wires
    prep = hostprep.prep_scan(scan, lobe, SPACING, vessel_u8=vessel)
    prepc = fast.prep_scan_chunks(scan, lobe, SPACING, vessel_u8=vessel,
                                  windowing_span=SPAN, chunk_size=CHUNK)
    got = {"p12": ppipe.process_prepped(prep, unpack=False,
                                        want_heatmap=True),
           "wc": ppipe.process_chunks(prepc, unpack=False)}
    want_wc = ppipe.process_chunks(prepc)
    for name, want in (("p12", runs["p12"][1]), ("wc", want_wc)):
        out = got[name]
        assert torch.is_tensor(out["threshold"]) and \
            torch.is_tensor(out["ratios"]) and "pred" not in out
        assert float(out["threshold"]) == want["threshold"]
        np.testing.assert_array_equal(out["ratios"].numpy(), want["ratios"])
    p = got["p12"]
    sl = tuple(slice(l, l + s) for l, s in zip(*p["out_window"]))
    np.testing.assert_array_equal(p["heatmap_window"].numpy(),
                                  runs["p12"][1]["heatmap_u8"][sl])
    w = got["wc"]
    assert w["masks_on_iso"] and w["post_packed"] is None
    pred = fast.expand_packed_mask(w["pred_packed"].numpy(), w["iso_shape"],
                                   w["out_shape"], *w["out_window"],
                                   w["back_tables"])
    np.testing.assert_array_equal(pred, want_wc["pred"])


def test_itk_resample3d_matches_jax():
    """The device iso resample against dram_tpu's itk_resample3d, linear
    (with fill) and nearest."""
    from dram_tpu.core.resample import itk_resample3d as jresample
    from dram_tpu_torch.core.resample import itk_resample3d
    rng = np.random.default_rng(3)
    x = rng.integers(-1000, 400, (12, 20, 17)).astype(np.float32)
    scales = [0.7, 1.3, 1.1]
    for method, out, fill in (("linear", (18, 16, 17), -2048.0),
                              ("nearest", (18, 16, 17), 0.0)):
        want = np.asarray(jresample(jnp.asarray(x), out, scales=scales,
                                    method=method, fill_value=fill))
        got = itk_resample3d(torch.from_numpy(x), out, scales, method,
                             fill_value=fill).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
        if method == "nearest":
            np.testing.assert_array_equal(got, want)


def test_cam_threshold_scaler_matches_jax():
    """binary_cam_threshold with scaler 0.75: the scaled Otsu bin, a
    single value unscaled, and an empty mask, as dram_tpu's."""
    from dram_tpu.core.ops import binary_cam_threshold as jth
    from dram_tpu_torch.core.ops import binary_cam_threshold
    jth_scaled = jax.jit(lambda v, m: jth(v, m, scaler=0.75))
    rng = np.random.default_rng(4)
    v = rng.random((10, 12, 8)).astype(np.float32)
    mask = v > 0.3
    for m in (mask, np.zeros_like(mask), None):
        for vals in (v, np.full_like(v, 0.4)):
            want = float(jth_scaled(jnp.asarray(vals), None if m is None
                                    else jnp.asarray(m)))
            got = float(binary_cam_threshold(
                torch.from_numpy(vals), None if m is None
                else torch.from_numpy(m), scaler=0.75))
            # the same u8 threshold (jit may fold the / 255 otherwise)
            assert got * 255 == pytest.approx(want * 255, abs=1e-4)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A failed build raises; nothing falls back to NumPy."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    scan, lobe, _ = _scan(1, (12, 16, 16))
    with pytest.raises(RuntimeError, match="cannot be built"):
        fast.prep_scan_chunks(scan, lobe, (1.0, 1.0, 1.0), chunk_size=CHUNK)
    with pytest.raises(ValueError, match="prep"):
        hostprep.prep_scan(scan, lobe, (1.0, 1.0, 1.0), prep="cpp")


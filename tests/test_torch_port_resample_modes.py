"""The port's `Resample` in all thirteen modes of its plan against
dram_tpu's on the CPU, and the ragged-grid slice: the host-stitch
engine's lobe preprocessing under "inplane_resolution_z_spacing" and a
narrow DC3DATGeneric forward at the odd depth it gives.

Tolerances: plans and resampled samples bit for bit (the same numpy
arithmetic and the same C++ resampler, one global np.random seed for the
random modes); the forward's logits 2e-4 absolute (+ 1e-3 relative), the
bar of tests/test_reference_parity.py at 32^3; the engine's
max-normalised CAM 1e-3 and its class equal."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dram_tpu.data import transforms as JT
from dram_tpu.infer.engine import LesionSegTest as JaxLesionSegTest
from dram_tpu.models import DC3DATGeneric as JaxDC3DATGeneric

from dram_tpu_torch import weights
from dram_tpu_torch.data import transforms as T
from dram_tpu_torch.infer.engine import LesionSegTest
from dram_tpu_torch.models import DC3DATGeneric

# (mode, factor, size): every mode of dram_tpu/data/transforms.py:147-208
MODES = [
    ("random_spacing", (0.8, 1.6), None),
    ("fixed_factor", 1.5, None),
    ("fixed_spacing", 1.2, None),
    ("fixed_spacing", (1.5, 0.9, 1.1), None),
    ("inplane_spacing_only", (0.0, 0.9, 1.3), None),
    ("inplane_resolution_only", None, (16, 20, 18)),
    ("inplane_resolution_z_spacing", (1.7, 0.0, 0.0), (16, 20, 18)),
    ("inplane_resolution_z_jittering", 0.3, (16, 20, 18)),
    ("inplane_resolution_min_z_spacing", (2.0, 0.0, 0.0), (16, 20, 18)),
    ("inplane_resolution_min_z_spacing", (0.5, 0.0, 0.0), (16, 20, 18)),
    ("fixed_spacing_min_in_plane_resolution", 1.0, (16, 20, 18)),
    ("fixed_spacing_min_in_plane_resolution", (1.0, 0.4, 0.4),
     (16, 20, 18)),
    ("iso_minimal", None, None),
    ("fixed_output_size", None, (16, 20, 18)),
    ("fixed_size", None, (16, 20, 18)),
    ("spacing_size_match", (1.1, 0.9, 1.3), (16, 20, 18)),
]
# (size, z-y-x spacing): thin slices, thick slices, near-isotropic
GEOMETRIES = [((21, 26, 24), (1.25, 0.8, 0.7)),
              ((9, 30, 28), (3.0, 0.6, 0.65)),
              ((17, 17, 19), (1.0, 1.1, 0.95))]
# st_dram_ref_att's widths / 8 and its attention at 16^3
NARROW = dict(base_ch_list=(4, 8, 8, 16, 16, 8, 8),
              end_ch_list=(8, 8, 16, 16, 16, 8, 8))
AT = dict(at_spatial_size=(16, 16, 16), at_f_dim=4, at_g_dim=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sample(size, spacing, seed=0):
    """int16 #image, u8 #lobe_reference and a 4-D float #weight_map."""
    rng = np.random.default_rng(seed)
    image = rng.integers(-1100, 200, size=size).astype(np.int16)
    lobe = (rng.uniform(size=size) < 0.6).astype(np.uint8) * \
        rng.integers(1, 6, size=size).astype(np.uint8)
    wmap = rng.uniform(size=(2,) + tuple(size)).astype(np.float32)
    return {"#image": image, "#lobe_reference": lobe, "#weight_map": wmap,
            "meta": {"uid": "s", "size": tuple(size), "spacing": spacing}}


@pytest.mark.parametrize("geometry", range(len(GEOMETRIES)))
def test_plan_of_every_mode(geometry):
    """Each mode's (spacing, size) plan equals dram_tpu's exactly, the
    random modes after the same np.random seed (and the draws leave the
    global stream at the same state)."""
    size, spacing = GEOMETRIES[geometry]
    sample = _sample(size, spacing)
    seen = set()
    for mode, factor, out in MODES:
        seen.add(mode)
        np.random.seed(7)
        got = T.Resample(mode, factor, out)._plan(sample)
        after = np.random.random()
        np.random.seed(7)
        want = JT.Resample(mode, factor, out)._plan(sample)
        assert np.random.random() == after
        assert type(got[1]) is type(want[1]), mode
        assert [float(v) for v in got[0]] == [float(v) for v in want[0]], \
            mode
        assert got[1] == want[1], mode
    assert len(seen) == 13
    with pytest.raises(ValueError):
        T.Resample("cubic", 1.0)._plan(sample)


@pytest.mark.parametrize("geometry", range(len(GEOMETRIES)))
def test_resample_call_bitwise(geometry):
    """Resample.__call__ of every mode on a sample with an int16 #image, a
    u8 #lobe_reference and a 4-D #weight_map: every array (values, dtype)
    and meta equal dram_tpu's, the random modes included."""
    size, spacing = GEOMETRIES[geometry]
    sample = _sample(size, spacing, seed=geometry)
    for mode, factor, out in MODES:
        np.random.seed(11)
        got = T.Resample(mode, factor, out)(sample)
        np.random.seed(11)
        want = JT.Resample(mode, factor, out)(sample)
        assert set(got) == set(want)
        for k in ("#image", "#lobe_reference", "#weight_map"):
            assert got[k].dtype == want[k].dtype, (mode, k)
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{mode} {k}")
        assert got["meta"] == want["meta"], mode
        assert got["#image"].dtype == np.int16
        assert got["#weight_map"].shape[1:] == got["#image"].shape


def _engine(cls, settings, **attrs):
    """An engine object for the unbound host-stitch methods: settings and
    whatever infer_lobe_chunk reads."""
    ns = types.SimpleNamespace(settings=settings, trace=False, **attrs)
    ns.preprocessing = lambda: cls.preprocessing(ns)
    return ns


def test_ragged_lobe_slice():
    """A lobe chunk (its crop masked to PAD_VALUE) through both engines'
    infer_lobe_chunk under RESAMPLE_MODE "inplane_resolution_z_spacing":
    the preprocessing gives both the same odd-depth grid bit for bit;
    the narrow DC3DATGeneric forward at that grid matches dram_tpu's
    (dense and refined logits, 2e-4); the CAM the engine stitches
    (resized back, ReLU'd, max-normalised) within 1e-3 and the class
    equal."""
    rng = np.random.default_rng(3)
    shape, spacing = (34, 37, 41), (1.0, 1.0, 1.0)
    z = np.arange(shape[0])[:, None, None]
    scan = (-850 + 150 * np.sin(z / 3.0)
            + rng.normal(size=shape) * 60).astype(np.int16)
    lobe = np.zeros(shape, np.uint8)
    lobe[2:-3, 4:-2, 3:-5] = 1
    scan[lobe == 0] = -2048
    settings = types.SimpleNamespace(
        WINDOWING_MIN=-1000, WINDOWING_MAX=-300,
        RESAMPLE_MODE="inplane_resolution_z_spacing",
        RESAMPLE_SPACING=(1.6, 1.0, 1.0), RESAMPLE_SIZE=(32, 32, 32))
    sample = {"#image": scan, "#lobe_reference": lobe,
              "meta": {"size": shape, "spacing": spacing}}
    got = T.Compose(_engine(LesionSegTest, settings).preprocessing())(sample)
    want = JT.Compose(_engine(JaxLesionSegTest, settings)
                      .preprocessing())(sample)
    for k in ("#image", "#lobe_reference"):
        np.testing.assert_array_equal(got[k], want[k])
    grid = got["#image"].shape
    assert grid == (21, 32, 32) and grid[0] % 2 == 1

    x = got["#image"][None, ..., None].astype(np.float32)
    jm = JaxDC3DATGeneric(train=False, **NARROW, **AT)
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    prng = np.random.default_rng(4)

    def draw(path, a):
        name = path[-1].key
        if name == "var":
            return prng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("scale",):
            return prng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return (prng.normal(size=a.shape) * 0.1).astype(np.float32)
        fan_in = int(np.prod(a.shape[:-1])) or 1
        return (prng.normal(size=a.shape) * np.sqrt(2.0 / fan_in)) \
            .astype(np.float32)
    v = jax.tree_util.tree_map_with_path(draw, v)
    jd, jr = jax.jit(jm.apply)(v, jnp.asarray(x))
    model = weights.load_into(DC3DATGeneric(**NARROW, **AT), v["params"],
                              v["batch_stats"]).eval()
    with torch.no_grad():
        d, r = model(torch.from_numpy(x))
    assert d.shape == r.shape == (1,) + grid + (1,)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=2e-4,
                               rtol=1e-3)

    port = _engine(LesionSegTest, settings, model=model,
                   device=torch.device("cpu"))
    cam, cls = LesionSegTest.infer_lobe_chunk(port, scan, lobe, spacing)
    fwd = jax.jit(lambda p, b, im: jm.apply({"params": p,
                                             "batch_stats": b}, im))
    jax_eng = _engine(JaxLesionSegTest, settings, params=v["params"],
                      batch_stats=v["batch_stats"],
                      _forward=lambda: lambda p, b, im, lo: fwd(p, b, im))
    jcam, jcls = JaxLesionSegTest.infer_lobe_chunk(jax_eng, scan, lobe,
                                                   spacing)
    assert cam.shape == jcam.shape == shape
    assert cls == jcls
    np.testing.assert_allclose(cam, jcam, atol=1e-3)
    assert cam.max() == 1.0 or cls == 0

"""The port's extended host-transform zoo (data/transforms.py) against
dram_tpu's on the CPU: each of the eighteen transforms, after the same
global np.random seed, on the same sample gives dram_tpu's arrays bit for
bit (tolerance 0: both run the same numpy and scipy calls), alone and
chained in a Compose with the ported training augmentations."""

import numpy as np
import pytest
import torch

from dram_tpu.data import transforms as JT

from dram_tpu_torch.data import transforms as T

SEEDS = (0, 1, 2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sample(seed=0, shape=(14, 18, 16), channels=False):
    """A float32 (or int16) #image, a u8 #lobe_reference and a float
    #weight_map; with `channels` the image is (2, D, H, W)."""
    rng = np.random.default_rng(seed)
    image = (rng.normal(size=shape) * 200 - 500).astype(np.float32)
    if channels:
        image = np.stack([image, image[::-1] * 0.5])
    lobe = rng.integers(0, 6, size=shape).astype(np.uint8)
    wmap = rng.uniform(size=shape).astype(np.float32)
    return {"#image": image, "#lobe_reference": lobe, "#weight_map": wmap,
            "meta": {"uid": "s", "size": shape, "spacing": (1.0, 1.0, 1.0)}}


def _same(got, want, what):
    assert set(got) == set(want), what
    for k in got:
        if k == "meta":
            assert got[k] == want[k], what
            continue
        assert got[k].dtype == want[k].dtype, (what, k)
        assert got[k].shape == want[k].shape, (what, k)
        np.testing.assert_array_equal(got[k], want[k],
                                      err_msg=f"{what} {k}")


def _check(make, samples, seeds=SEEDS):
    """make(module) -> transform; equal outputs and the same np.random
    state after, for each seed and sample."""
    for seed in seeds:
        for sample in samples:
            np.random.seed(seed)
            got = make(T)(sample)
            after = np.random.random()
            np.random.seed(seed)
            want = make(JT)(sample)
            assert np.random.random() == after
            _same(got, want, f"{make(T).__class__.__name__} seed {seed}")
            yield got


INTENSITY = [
    lambda m: m.IntensityInverse(),
    lambda m: m.GammaTransform(),
    lambda m: m.GammaTransform((0.5, 0.6)),
    lambda m: m.ContrastJitter(),
    lambda m: m.ContrastJitter((0.5, 2.0), if_keep_range=False),
    lambda m: m.ContrastStretchingTransform(),
    lambda m: m.ContrastStretchingTransform((10, 90)),
    lambda m: m.HistogramEqual(),
    lambda m: m.HistogramEqual(32),
    lambda m: m.StandarizeChannel(),
]


def test_intensity_transforms():
    """IntensityInverse, GammaTransform, ContrastJitter,
    ContrastStretchingTransform, HistogramEqual and StandarizeChannel on
    float32 and int16 images, one and two channels; the other keys pass
    through untouched."""
    int_sample = _sample(3)
    int_sample["#image"] = np.round(int_sample["#image"]).astype(np.int16)
    samples = [_sample(), _sample(1, channels=True), int_sample]
    for make in INTENSITY:
        for out, sample in zip(_check(make, samples), samples * 3):
            assert np.isfinite(out["#image"]).all()
            assert out["#lobe_reference"] is sample["#lobe_reference"]


CROPS_AND_MASKS = [
    lambda m: m.CenterCrop((0.5, 0.75, 0.9)),
    lambda m: m.RandomCrop(),
    lambda m: m.RandomCrop((0.3, 0.5)),
    lambda m: m.RandomCubeMask(),
    lambda m: m.RandomCubeMask(5, (0.1, 0.4), fill="zero"),
    lambda m: m.RandomMaskGaussian(),
    lambda m: m.RandomMaskGaussian(4, (0.2, 0.5), sigma=0.5),
    lambda m: m.DiskMaskOut(),
    lambda m: m.DiskMaskOut(0.8),
]


def test_crops_and_masks():
    """CenterCrop (meta's size follows), RandomCrop (resampled back to the
    shape: C++ linear on the image and weight map, nearest on the
    lobes), RandomCubeMask, RandomMaskGaussian and DiskMaskOut."""
    samples = [_sample(), _sample(2, (11, 20, 13), channels=True)]
    for make in CROPS_AND_MASKS:
        # RandomCrop resamples (D, H, W) keys only, as dram_tpu's does
        list(_check(make, samples[:1] if isinstance(make(T), T.RandomCrop)
                    else samples))
    out = T.CenterCrop((0.5, 0.75, 0.9))(_sample())
    assert out["meta"]["size"] == (7, 13, 14) == out["#image"].shape


AXES_AND_ROTATIONS = [
    lambda m: m.RandomMoveAxis(),
    lambda m: m.RandomRotate(),
    lambda m: m.RandomRotate((-40, 40), axes=(-3, -1)),
    lambda m: m.RandomRotateInplane90(),
    lambda m: m.RandomAffineTransform3D(),
    lambda m: m.RandomAffineTransform3D((-30, 30), (0.7, 1.3)),
]


def test_axes_and_rotations():
    """RandomMoveAxis, RandomRotate and RandomAffineTransform3D (scipy:
    references nearest, images linear) and RandomRotateInplane90."""
    samples = [_sample(4), _sample(5, (12, 15, 17))]
    for make in AXES_AND_ROTATIONS:
        for out in _check(make, samples):
            assert set(np.unique(out["#lobe_reference"])) <= set(range(6))


def test_projections():
    """_trailing_projection equals the reference's clipped trailing window
    (a direct loop) and dram_tpu's; MinimalIntensityProjection,
    MinimalIntensityAxialProjection (the raw slab thickness, the
    reference's defect kept) and MaximumIntensityProjection."""
    x = _sample(6)["#image"]
    for slab in (1, 3, 6):
        for axis in (-3, -2, -1):
            for reduce_max in (False, True):
                got = T._trailing_projection(x, slab, axis, reduce_max)
                np.testing.assert_array_equal(
                    got, JT._trailing_projection(x, slab, axis, reduce_max))
                xm = np.moveaxis(x, axis, 0)
                f = np.max if reduce_max else np.min
                loop = np.stack([f(xm[max(0, i - slab):i + 1], axis=0)
                                 for i in range(xm.shape[0])])
                np.testing.assert_array_equal(np.moveaxis(got, axis, 0),
                                              loop)
    samples = [_sample(7), _sample(8, channels=True)]
    for make in (lambda m: m.MinimalIntensityProjection(),
                 lambda m: m.MinimalIntensityProjection((2, 4), (1, 3)),
                 lambda m: m.MinimalIntensityAxialProjection(),
                 lambda m: m.MaximumIntensityProjection()):
        list(_check(make, samples))
    np.random.seed(0)
    t = T.MinimalIntensityAxialProjection((5, 6))
    assert t._draw() == (5, 0)


def test_compose_with_the_augmentations():
    """The zoo chained with the ported training augmentations and the
    resample in one Compose: dram_tpu's arrays bit for bit, seed by
    seed."""
    def chain(m):
        return m.Compose([
            m.Resample("inplane_resolution_z_jittering", 0.2, (12, 16, 16)),
            m.RandomCrop(), m.GaussianBlur((0.3, 0.5), "random"),
            m.RandomFlip(), m.ContrastJitter(), m.RandomRotate(),
            m.RandomMaskOut(region_size=((0.05, 0.2),) * 3),
            m.RandomCubeMask(), m.RandomRotate90(), m.GammaTransform(),
            m.RandomAffineTransform3D(), m.GaussianAddictive((0.01, 0.02)),
            m.MaximumIntensityProjection(), m.HistogramEqual(),
            m.StandarizeChannel()])
    sample = _sample(9)
    sample["#image"] = np.round(sample["#image"]).astype(np.int16)
    for seed in SEEDS:
        np.random.seed(seed)
        got = chain(T)(sample)
        np.random.seed(seed)
        want = chain(JT)(sample)
        _same({k: v for k, v in got.items() if k != "meta"},
              {k: v for k, v in want.items() if k != "meta"},
              f"chain seed {seed}")
        assert np.isfinite(got["#image"]).all()

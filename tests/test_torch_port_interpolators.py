"""The port's ITK interpolators (core/resample.py), `resample_array` and
`resample_mha_file` against dram_tpu's on the CPU, same numpy inputs.

Tolerances: the weight matrices, the host twins, `resample_array` and the
files bit for bit (both packages run the same float64 / float32 numpy
arithmetic); the tensor resample (torch.matmul in f32) against dram_tpu's
jnp resample within 1e-5 of max |x|; label_gaussian's labels equal."""

import numpy as np
import pytest
import torch

from dram_tpu.core import resample as jres
from dram_tpu.data import io as jio
from dram_tpu.data import transforms as JT

from dram_tpu_torch.core import resample
from dram_tpu_torch.data import io
from dram_tpu_torch.data import transforms as T

NEW_MODES = ("itk_bspline", "itk_gaussian", "itk_hamming_sinc",
             "itk_cosine_sinc", "itk_welch_sinc", "itk_lanczos_sinc")
# (in, out, scale, Gaussian sigma): down, up, scale None, a scale whose
# grid runs past the input (outputs take the fill value), one sample
GEOMETRIES = ((17, 11, 1.5, None), (9, 23, 0.4, 0.7), (12, 12, None, 2.0),
              (10, 14, 0.9, None), (1, 3, 0.5, None))
SHAPE = (12, 17, 20)
OUT = (9, 23, 14)
SCALES = (1.3, 0.7, 1.4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _volume(seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 300 - 600).astype(np.float32)


def _labels(seed=1, shape=SHAPE):
    rng = np.random.default_rng(seed)
    z = np.arange(shape[0])[:, None, None]
    y = np.arange(shape[1])[None, :, None]
    lab = ((z * 5 // shape[0]) + (y > shape[1] // 2)).astype(np.int16)
    return np.broadcast_to(lab, shape).copy() \
        + (rng.uniform(size=shape) < 0.05).astype(np.int16)


def test_axis_weights_of_every_new_mode_bitwise():
    """W and valid of the B-spline, Gaussian and four windowed-sinc modes
    equal dram_tpu's bit for bit at each geometry."""
    for mode in NEW_MODES:
        for n_in, n_out, scale, sigma in GEOMETRIES:
            W, v = resample._axis_weights(n_in, n_out, mode, scale, sigma)
            jW, jv = jres._axis_weights(n_in, n_out, mode, scale, sigma)
            assert W.dtype == jW.dtype == np.float32, mode
            np.testing.assert_array_equal(W, jW, err_msg=mode)
            np.testing.assert_array_equal(v, jv, err_msg=mode)
    # the old modes too, and an unknown one raises in both
    for mode in ("linear_ac", "linear_hp", "nearest_torch", "itk_linear",
                 "itk_nearest"):
        np.testing.assert_array_equal(
            resample._axis_weights(13, 7, mode, 1.7)[0],
            jres._axis_weights(13, 7, mode, 1.7)[0])
    with pytest.raises(ValueError):
        resample._axis_weights(4, 4, "cubic", None)
    assert resample.ITK_METHODS == jres.ITK_METHODS


def test_host_twins_bitwise():
    """itk_resample3d_np of every ITK_METHODS name, with scales and with
    scales=None, and a fill value, equals dram_tpu's bit for bit."""
    x = _volume()
    for method in resample.ITK_METHODS:
        for scales in (SCALES, None):
            got = resample.itk_resample3d_np(x, OUT, scales, method, -7.0)
            want = jres.itk_resample3d_np(x, OUT, scales=scales,
                                          method=method, fill_value=-7.0)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{method} {scales}")


def test_tensor_resample_against_jnp():
    """The tensor itk_resample3d of every ITK_METHODS name against
    dram_tpu's jnp itk_resample3d: max abs error <= 1e-5 of max |x|; the
    output keeps a floating input's dtype."""
    x = _volume(2)
    lim = 1e-5 * np.abs(x).max()
    for method in resample.ITK_METHODS:
        for scales in (SCALES, None):
            got = resample.itk_resample3d(torch.from_numpy(x), OUT, scales,
                                          method, 5.0)
            want = np.asarray(jres.itk_resample3d(x, OUT, scales=scales,
                                                  method=method,
                                                  fill_value=5.0))
            assert got.dtype == torch.float32 and got.shape == OUT
            err = np.abs(got.numpy() - want).max()
            assert err <= lim, (method, scales, err, lim)
    y = resample.itk_resample3d(torch.from_numpy(x).double(), OUT, SCALES,
                                "bspline")
    assert y.dtype == torch.float64
    with pytest.raises(ValueError):
        resample.itk_resample3d(torch.from_numpy(x), OUT, SCALES, "cubic")


def test_label_gaussian_labels_equal():
    """'label_gaussian' on the host and on a tensor gives dram_tpu's labels,
    in the input's dtype; outside-buffer voxels take the fill value."""
    lab = _labels()
    for scales, fill in ((SCALES, 0), ((2.0, 1.0, 1.0), 9)):
        want = jres.itk_resample3d_np(lab, OUT, scales=scales,
                                      method="label_gaussian",
                                      fill_value=fill)
        got = resample.itk_resample3d_np(lab, OUT, scales, "label_gaussian",
                                         fill)
        assert got.dtype == want.dtype == np.int16
        np.testing.assert_array_equal(got, want)
        t = resample.itk_resample3d(torch.from_numpy(lab), OUT, scales,
                                    "label_gaussian", fill)
        np.testing.assert_array_equal(t.numpy(), want)
    assert (want == 9).any()  # the (2, 1, 1) grid runs past the input


def test_itk_resample_to_spacing():
    """Array and spacing of itk_resample_to_spacing for out_spacing, for
    out_size and for both, against dram_tpu's (jnp: 1e-5 of max |x|;
    spacings equal); without either it raises."""
    x = _volume(3)
    lim = 1e-5 * np.abs(x).max()
    for kw in ({"out_spacing": (1.0, 1.0, 1.0)}, {"out_size": (10, 9, 30)},
               {"out_spacing": (0.9, 1.2, 0.5), "out_size": (8, 8, 8)}):
        for method in ("linear", "lanczos_windowed_sinc"):
            y, sp = resample.itk_resample_to_spacing(
                torch.from_numpy(x), (1.25, 0.8, 0.7), method=method, **kw)
            jy, jsp = jres.itk_resample_to_spacing(
                x, (1.25, 0.8, 0.7), method=method, **kw)
            assert sp == jsp and tuple(y.shape) == tuple(jy.shape)
            assert np.abs(y.numpy() - np.asarray(jy)).max() <= lim
    with pytest.raises(ValueError):
        resample.itk_resample_to_spacing(torch.from_numpy(x), (1, 1, 1))


def test_resample_array_every_interpolator_int16():
    """resample_array of an int16 scan with each interpolator name (the
    C++ linear, the NumPy twin for the others) and of an int16 label map
    with 'label_gaussian': dram_tpu's arrays bit for bit, in int16, and
    the same spacing."""
    x = np.round(_volume(4)).astype(np.int16)
    for method in resample.ITK_METHODS:
        got, sp = T.resample_array(x, (1.25, 0.8, 0.7), (1.6, 1.0, 0.5),
                                   interpolator=method)
        want, jsp = JT.resample_array(x, (1.25, 0.8, 0.7), (1.6, 1.0, 0.5),
                                      interpolator=method)
        assert got.dtype == want.dtype == np.int16, method
        assert sp == jsp
        np.testing.assert_array_equal(got, want, err_msg=method)
    lab = _labels()
    got, _ = T.resample_array(lab, (1.0, 1.0, 1.0), new_size=OUT,
                              interpolator="label_gaussian")
    want, _ = JT.resample_array(lab, (1.0, 1.0, 1.0), new_size=OUT,
                                interpolator="label_gaussian")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_resample_mha_file(tmp_path, dtype):
    """resample_mha_file on a temporary .mha (int16: rounded and cast, no
    clip; float32 as computed), for two interpolators and factors: the
    written array, its dtype and every header field equal dram_tpu's
    output file's, and the returned name is the output's."""
    x = _volume(5).astype(dtype)
    src = str(tmp_path / "in.mha")
    io.write_mha(src, x, spacing=(1.25, 0.8, 0.7), origin=(-3.0, 4.5, 1.0),
                 direction=(1, 0, 0, 0, 0, -1, 0, 1, 0))
    for factor, method in ((2, "linear"), (1.5, "bspline"),
                           (0.75, "welch_windowed_sinc")):
        a = str(tmp_path / f"port_{factor}_{method}.mha")
        b = str(tmp_path / f"jax_{factor}_{method}.mha")
        assert io.resample_mha_file(src, a, factor, method) == a
        jio.resample_mha_file(src, b, factor, method)
        got, want = io.read_mha(a), jio.read_mha(b)
        assert got["array"].dtype == want["array"].dtype == np.dtype(dtype)
        np.testing.assert_array_equal(got["array"], want["array"])
        for k in ("spacing", "origin", "direction"):
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()

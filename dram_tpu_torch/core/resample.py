"""Separable 3-D resampling: trilinear (align-corners or half-pixel) and
nearest resizes, the strictly local 2x upsample and the ITK-semantics
grid resample with every interpolator of the reference, on tensors and
on host arrays.

Port of dram_tpu/core/resample.py (`_axis_weights` :75 and its helpers
:30-72, `resize3d` :197, `ITK_METHODS` :232, `_label_gaussian_resample`
:244, `itk_resample3d` :260, `itk_resample_to_spacing` :300,
`upsample2x_local` :324, `resize3d_np` :349, `itk_resample3d_np` :365):
each axis is resized by a dense (out, in) weight matrix (<= 2 non-zeros
a row for linear and nearest, the kernel's taps for the others), built
in float64 and stored as float32 exactly as the JAX package builds it.
"""

from __future__ import annotations

import functools
from math import erf

import numpy as np
import torch


def _sinc(x):
    return np.sinc(x)  # sin(pi x) / (pi x), sinc(0) = 1


# windowed-sinc windows over |x| <= m (ITK
# itkWindowedSincInterpolateImageFunction.h; radius 3, SimpleITK's
# default for its Hamming, Cosine, Welch and Lanczos windowed sincs)
_SINC_RADIUS = 3
_SINC_WINDOWS = {
    "itk_hamming_sinc": lambda x, m: 0.54 + 0.46 * np.cos(np.pi * x / m),
    "itk_cosine_sinc": lambda x, m: np.cos(np.pi * x / (2 * m)),
    "itk_welch_sinc": lambda x, m: 1.0 - (x / m) ** 2,
    "itk_lanczos_sinc": lambda x, m: _sinc(x / m),
}


@functools.lru_cache(maxsize=64)
def _bspline_coeff_matrix(n: int):
    """(n, n) inverse of the cubic B-spline collocation matrix under
    mirror (whole-sample symmetric) extension: the prefilter of an
    interpolating cubic spline (ITK BSplineInterpolateImageFunction of
    order 3, as one dense solve)."""
    if n == 1:
        return np.ones((1, 1), np.float32)
    M = np.zeros((n, n), np.float64)
    for i in range(n):
        for j, w in ((i - 1, 1 / 6), (i, 2 / 3), (i + 1, 1 / 6)):
            jm = -j if j < 0 else (2 * (n - 1) - j if j > n - 1 else j)
            M[i, jm] += w
    return np.linalg.inv(M).astype(np.float32)


def _bspline3(x):
    ax = np.abs(x)
    return np.where(ax < 1, 2 / 3 - ax ** 2 + ax ** 3 / 2,
                    np.where(ax < 2, (2 - ax) ** 3 / 6, 0.0))


def _mirror_idx(j, n):
    j = np.abs(j)
    if n > 1:
        j = np.where(j > n - 1, 2 * (n - 1) - j, j)
    return np.clip(j, 0, n - 1)


def _kernel_weights(in_size, out_size, mode, scale, param):
    """The B-spline, Gaussian and windowed-sinc modes: separable kernels
    on the ITK grid (src = i * scale). Out-of-range taps clamp (sinc,
    Gaussian) or mirror (B-spline) to the edge sample; outputs whose
    source point leaves [-0.5, in - 0.5) get weight 0 and `valid` 0."""
    W = np.zeros((out_size, in_size), np.float32)
    s = (in_size / out_size) if scale is None else scale
    src = np.arange(out_size) * s
    valid = ((src >= -0.5) & (src < in_size - 0.5)).astype(np.float32)
    src = np.clip(src, 0.0, in_size - 1)
    rows = np.arange(out_size)
    base = np.floor(src).astype(np.int64)
    if mode in _SINC_WINDOWS:
        # w(x) = window(x) sinc(x), radius 3, not normalised (ITK
        # WindowedSincInterpolateImageFunction); exact at integer src
        m = _SINC_RADIUS
        for k in range(-m + 1, m + 1):
            j = base + k
            x = src - j
            w = _SINC_WINDOWS[mode](x, m) * _sinc(x)
            w = np.where(np.abs(x) <= m, w, 0.0)
            np.add.at(W, (rows, np.clip(j, 0, in_size - 1)),
                      (w * valid).astype(np.float32))
        return W, valid
    if mode == "itk_bspline":
        # interpolating cubic spline: evaluation basis times prefilter
        B = np.zeros((out_size, in_size), np.float64)
        for k in range(-1, 3):
            j = base + k
            np.add.at(B, (rows, _mirror_idx(j, in_size)), _bspline3(src - j))
        W = B @ _bspline_coeff_matrix(in_size).astype(np.float64)
        return (W * valid[:, None]).astype(np.float32), valid
    # itk_gaussian: cell-integrated Gaussian, normalised (ITK
    # GaussianInterpolateImageFunction); sigma `param` (default 1.0) in
    # input voxels, taps within 4 sigma
    sig = 1.0 if param is None else float(param)
    r = max(1, int(np.ceil(4.0 * sig)))
    erfv = np.vectorize(erf)
    den = np.sqrt(2.0) * sig
    for k in range(-r, r + 2):
        j = base + k
        d = j - src
        w = 0.5 * (erfv((d + 0.5) / den) - erfv((d - 0.5) / den))
        np.add.at(W, (rows, np.clip(j, 0, in_size - 1)),
                  w.astype(np.float32))
    W /= np.maximum(W.sum(axis=1, keepdims=True), 1e-12)
    return (W * valid[:, None]).astype(np.float32), valid


@functools.lru_cache(maxsize=512)
def _axis_weights(in_size: int, out_size: int, mode: str,
                  scale: float | None, param: float | None = None):
    """(out, in) float32 weight matrix + (out,) validity vector.

    Modes: 'linear_ac' (torch align_corners=True), 'linear_hp' (torch
    align_corners=False, half-pixel), 'nearest_torch' (torch
    F.interpolate nearest), and on SimpleITK's grid (src = i * scale,
    points outside [-0.5, in - 0.5) take the fill value) 'itk_linear',
    'itk_nearest', 'itk_bspline', 'itk_gaussian' and the windowed sincs
    'itk_hamming_sinc', 'itk_cosine_sinc', 'itk_welch_sinc' and
    'itk_lanczos_sinc'. `scale` is new/old spacing for the itk modes
    (None means in/out); `param` is the Gaussian sigma in input voxels."""
    if mode in _SINC_WINDOWS or mode in ("itk_bspline", "itk_gaussian"):
        return _kernel_weights(in_size, out_size, mode, scale, param)
    W = np.zeros((out_size, in_size), np.float32)
    valid = np.ones((out_size,), np.float32)
    if mode == "linear_ac":
        if out_size == 1:
            src = np.zeros((1,))
        else:
            src = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    elif mode == "linear_hp":
        src = (np.arange(out_size) + 0.5) * in_size / out_size - 0.5
        src = np.clip(src, 0.0, in_size - 1)
    elif mode == "nearest_torch":
        idx = np.floor(np.arange(out_size) * in_size / out_size) \
            .astype(np.int64)
        idx = np.clip(idx, 0, in_size - 1)
        W[np.arange(out_size), idx] = 1.0
        return W, valid
    elif mode in ("itk_linear", "itk_nearest"):
        s = (in_size / out_size) if scale is None else scale
        src = np.arange(out_size) * s
        valid = ((src >= -0.5) & (src < in_size - 0.5)).astype(np.float32)
        if mode == "itk_nearest":
            idx = np.floor(src + 0.5).astype(np.int64)  # round-half-up
            idx = np.clip(idx, 0, in_size - 1)
            W[np.arange(out_size), idx] = valid
            return W, valid
        src = np.clip(src, 0.0, in_size - 1)
    else:
        raise ValueError(f"unknown resize mode {mode}")
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float32)
    rows = np.arange(out_size)
    np.add.at(W, (rows, lo), (1.0 - frac) * valid)
    np.add.at(W, (rows, hi), frac * valid)
    return W, valid


def _spatial_axes(ndim):
    if ndim in (3, 4):  # (D, H, W) or (D, H, W, C)
        return (0, 1, 2)
    if ndim == 5:  # (B, D, H, W, C)
        return (1, 2, 3)
    raise ValueError(f"resize3d expects 3/4/5-D input, got {ndim}-D")


def resize3d(x, out_size, method="trilinear", align_corners=True):
    """torch F.interpolate-semantics resize of (D, H, W), (D, H, W, C) or
    (B, D, H, W, C), computed in f32 and returned in x's dtype
    (dram_tpu resize3d): 'trilinear' with align_corners (the model's
    upsampling) or half-pixel (align_corners=False, the one-shot
    rescale), or torch's 'nearest'."""
    if method == "trilinear":
        mode = "linear_ac" if align_corners else "linear_hp"
    elif method == "nearest":
        mode = "nearest_torch"
    else:
        raise ValueError(method)
    dtype = x.dtype
    y = x.float()
    for ax, o in zip(_spatial_axes(x.ndim), out_size):
        if y.shape[ax] == int(o):
            continue
        W, _ = _axis_weights(y.shape[ax], int(o), mode, None)
        Wt = torch.from_numpy(W).to(y.device)
        y = torch.movedim(torch.movedim(y, ax, -1) @ Wt.T, -1, ax)
    return y.to(dtype) if dtype.is_floating_point else y


def upsample2x_local(x):
    """Strictly local 2x trilinear upsample, half-pixel centres, edges
    clamped: out[2i] = 0.25 in[i-1] + 0.75 in[i], out[2i+1] = 0.75 in[i] +
    0.25 in[i+1] (dram_tpu/core/resample.py:324-346), in x's dtype."""
    for ax in _spatial_axes(x.ndim):
        n = x.shape[ax]
        lo = torch.cat([x.narrow(ax, 0, 1), x.narrow(ax, 0, n - 1)], ax)
        hi = torch.cat([x.narrow(ax, 1, n - 1), x.narrow(ax, n - 1, 1)], ax)
        even = 0.25 * lo + 0.75 * x
        odd = 0.75 * x + 0.25 * hi
        shape = list(x.shape)
        shape[ax] *= 2
        x = torch.stack([even, odd], dim=ax + 1).reshape(shape)
    return x


# the reference's interpolator names (its utils.py:286-296
# _SITK_INTERPOLATOR_DICT) -> _axis_weights modes
ITK_METHODS = {
    "linear": "itk_linear",
    "nearest": "itk_nearest",
    "bspline": "itk_bspline",
    "gaussian": "itk_gaussian",
    "hamming_sinc": "itk_hamming_sinc",
    "cosine_windowed_sinc": "itk_cosine_sinc",
    "welch_windowed_sinc": "itk_welch_sinc",
    "lanczos_windowed_sinc": "itk_lanczos_sinc",
}


def _label_gaussian_resample(x, out_size, scales, fill_value):
    """ITK LabelImageGaussianInterpolate: each label's indicator smoothed
    by the 'gaussian' kernel (on the host twin), argmax over labels;
    voxels outside the buffer (every vote at the -1 fill) take
    `fill_value`. Host-side: the labels come from the data."""
    xv = np.asarray(x)
    labels = np.unique(xv)
    stack = np.stack([itk_resample3d_np((xv == lb).astype(np.float32),
                                        out_size, scales=scales,
                                        method="gaussian", fill_value=-1.0)
                      for lb in labels])
    out = np.asarray(labels)[np.argmax(stack, axis=0)].astype(xv.dtype)
    return np.where(stack.max(axis=0) < 0, np.asarray(fill_value, xv.dtype),
                    out)


def _itk_mode(method):
    mode = ITK_METHODS.get(method)
    if mode is None:
        raise ValueError(f"unknown interpolator {method!r}; one of "
                         f"{sorted(ITK_METHODS) + ['label_gaussian']}")
    return mode


def itk_resample3d(x, out_size, scales=None, method="linear",
                   fill_value=0.0):
    """SimpleITK-style grid resample of a (D, H, W) tensor by per-axis
    new/old spacing `scales` (None: in/out), in f32 on x's device;
    outside-buffer voxels take `fill_value`. `method` is any ITK_METHODS
    name (nearest gathers, the others contract each axis with its weight
    matrix, torch.matmul in f32) or 'label_gaussian' (on the host, the
    result moved to x's device). A floating input comes back in its
    dtype, an integer one in f32."""
    if x.ndim != 3:
        raise ValueError("itk_resample3d operates on (D, H, W) volumes")
    if method == "label_gaussian":
        return torch.from_numpy(_label_gaussian_resample(
            x.cpu().numpy(), out_size, scales, fill_value)).to(x.device)
    mode = _itk_mode(method)
    if scales is None:
        scales = [None] * 3
    y = x.float()
    valid_mask = None
    for ax in range(3):
        W, valid = _axis_weights(
            y.shape[ax], int(out_size[ax]), mode,
            None if scales[ax] is None else float(scales[ax]))
        if mode == "itk_nearest":
            idx = torch.from_numpy(np.argmax(W, axis=1)).to(y.device)
            y = y.index_select(ax, idx)
        else:
            Wt = torch.from_numpy(W).to(y.device)
            y = torch.movedim(torch.movedim(y, ax, -1) @ Wt.T, -1, ax)
        v = torch.from_numpy(valid).to(y.device) \
            .reshape([-1 if i == ax else 1 for i in range(3)])
        valid_mask = v if valid_mask is None else valid_mask * v
    if mode == "itk_nearest":
        y = y * valid_mask
    y = y + (1.0 - valid_mask) * fill_value
    return y.to(x.dtype) if x.dtype.is_floating_point else y


def itk_resample_to_spacing(x, in_spacing, out_spacing=None, out_size=None,
                            method="linear", fill_value=0.0):
    """Resample a (D, H, W) tensor from `in_spacing` to `out_spacing`
    (z-y-x mm); returns (tensor, out spacing). Without `out_size` the
    grid is ceil(in_size * in_spacing / out_spacing); without
    `out_spacing` it is in_spacing * in_size / out_size. The spacing
    drives the index mapping, the size bounds the grid (ITK)."""
    in_spacing = np.asarray(in_spacing, np.float64)
    if out_spacing is None:
        if out_size is None:
            raise ValueError("need out_spacing or out_size")
        out_spacing = in_spacing * np.asarray(x.shape) / np.asarray(out_size)
    out_spacing = np.asarray(out_spacing, np.float64)
    if out_size is None:
        out_size = np.ceil(np.asarray(x.shape) * in_spacing
                           / out_spacing).astype(int)
    y = itk_resample3d(x, tuple(int(s) for s in out_size),
                       scales=(out_spacing / in_spacing).tolist(),
                       method=method, fill_value=fill_value)
    return y, tuple(float(s) for s in out_spacing)


def resize3d_np(x, out_size, method="trilinear"):
    """Host twin of resize3d ('trilinear': align-corners; 'nearest':
    torch's nearest) of a (D, H, W) or (D, H, W, C) array, in f32."""
    mode = {"trilinear": "linear_ac", "nearest": "nearest_torch"}[method]
    y = np.asarray(x, np.float32)
    for ax, o in zip(_spatial_axes(y.ndim), out_size):
        if y.shape[ax] == int(o):
            continue
        W, _ = _axis_weights(y.shape[ax], int(o), mode, None)
        y = np.moveaxis(np.moveaxis(y, ax, -1) @ W.T, -1, ax)
    return y


def itk_resample3d_np(x, out_size, scales=None, method="linear",
                      fill_value=0.0):
    """SimpleITK-style grid resample of a (D, H, W) host array by per-axis
    new/old spacing `scales` (None: in/out), any ITK_METHODS name or
    'label_gaussian'; outside-buffer voxels take `fill_value`. The same
    float32 matrix products as the JAX package's host twin."""
    if method == "label_gaussian":
        return _label_gaussian_resample(x, out_size, scales, fill_value)
    mode = _itk_mode(method)
    if scales is None:
        scales = [None] * 3
    y = np.asarray(x, np.float32)
    valid_mask = None
    for ax in range(3):
        W, valid = _axis_weights(
            y.shape[ax], int(out_size[ax]), mode,
            None if scales[ax] is None else float(scales[ax]))
        y = np.moveaxis(np.moveaxis(y, ax, -1) @ W.T, -1, ax)
        v = valid.reshape([-1 if i == ax else 1 for i in range(3)])
        valid_mask = v if valid_mask is None else valid_mask * v
    return y + (1.0 - valid_mask) * fill_value

"""Separable 3-D resampling: trilinear (align-corners or half-pixel) and
nearest resizes, the strictly local 2x upsample and the ITK-semantics
grid resample, on tensors and on host arrays.

Port of dram_tpu/core/resample.py (`resize3d` :197, `upsample2x_local`
:324, `itk_resample3d` :260, `resize3d_np` :349, `itk_resample3d_np`
:365, `_axis_weights` :73) for the modes the model, the equivariance
losses and the inference paths use: each
axis is resized by a dense (out, in) weight matrix with <= 2 non-zeros
per row, built in float64 and stored as float32 exactly as the JAX
package builds it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=512)
def _axis_weights(in_size: int, out_size: int, mode: str,
                  scale: float | None):
    """(out, in) float32 weight matrix + (out,) validity vector.

    Modes: 'linear_ac' (torch align_corners=True), 'linear_hp' (torch
    align_corners=False, half-pixel), 'nearest_torch' (torch
    F.interpolate nearest), 'itk_linear' and
    'itk_nearest' (SimpleITK: src = i * scale, points outside
    [-0.5, in - 0.5) take the fill value). `scale` is new/old spacing for
    the itk modes (None means in/out)."""
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
        raise NotImplementedError(
            f"resize mode {mode!r} is not ported (ROADMAP Queue 1, data "
            "layer)")
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


def itk_resample3d(x, out_size, scales, method="linear", fill_value=0.0):
    """SimpleITK-style grid resample of a (D, H, W) tensor ('linear' or
    'nearest') by per-axis new/old spacing `scales`, in f32 on x's
    device; outside-buffer voxels take `fill_value`. Linear contracts
    each axis with its weight matrix (torch.matmul in f32), nearest
    gathers."""
    if x.ndim != 3:
        raise ValueError("itk_resample3d operates on (D, H, W) volumes")
    mode = {"linear": "itk_linear", "nearest": "itk_nearest"}.get(method)
    if mode is None:
        raise NotImplementedError(
            f"interpolator {method!r} is not ported (ROADMAP Queue 1, data "
            "layer)")
    y = x.float()
    valid_mask = None
    for ax in range(3):
        W, valid = _axis_weights(y.shape[ax], int(out_size[ax]), mode,
                                 float(scales[ax]))
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
    return y + (1.0 - valid_mask) * fill_value


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


def itk_resample3d_np(x, out_size, scales, method="linear", fill_value=0.0):
    """SimpleITK-style grid resample of a (D, H, W) host array ('linear' or
    'nearest') by per-axis new/old spacing `scales`; outside-buffer voxels
    take `fill_value`. Same float32 matrix products as the JAX package's
    host twin."""
    mode = {"linear": "itk_linear", "nearest": "itk_nearest"}.get(method)
    if mode is None:
        raise NotImplementedError(
            f"interpolator {method!r} is not ported (ROADMAP Queue 1, data "
            "layer)")
    y = np.asarray(x, np.float32)
    valid_mask = None
    for ax in range(3):
        W, valid = _axis_weights(y.shape[ax], int(out_size[ax]), mode,
                                 float(scales[ax]))
        y = np.moveaxis(np.moveaxis(y, ax, -1) @ W.T, -1, ax)
        v = valid.reshape([-1 if i == ax else 1 for i in range(3)])
        valid_mask = v if valid_mask is None else valid_mask * v
    return y + (1.0 - valid_mask) * fill_value

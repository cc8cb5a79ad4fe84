"""Imaging ops of the chunk-wire path (windowing, Otsu, CAM threshold and
1-bit mask packing, on tensors and host arrays) and the masked reductions
of the losses.

Port of dram_tpu/core/ops.py (`windowing` :24, `otsu_threshold_u8` :89,
`otsu_threshold_from_hist` :133, `otsu_threshold_u8_np` :153,
`binary_cam_threshold` :174, `pooling_dense_features` :197,
`masked_mean` :213, `gsum` :219,
`packbits_u8` :302, `unpackbits_u8_dev` :317, `unpackbits_np` :329) and
its host twins of the inference engine (`windowing_np` :39,
`binary_cam_np` :160, `find_crops_np` :238). The TPU's one-hot-matmul
histogram (`histogram256_mxu`) becomes torch.bincount.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import all_reduce_sum

# CT severity score -> lesion-ratio interval per lobe
# (dram_tpu/losses/interval_reg.py:24-25)
CTSS_RATIO_LB = np.array([0.0, 0.001, 0.01, 0.05, 0.35, 0.5], np.float32)
CTSS_RATIO_UB = np.array([0.001, 0.01, 0.05, 0.35, 0.5, 1.00001],
                         np.float32)


def windowing(image, from_span=(-1150, 350), to_span=(0, 255)):
    """Clip to `from_span` and rescale linearly to `to_span`."""
    lo, hi = from_span
    image = torch.clamp(image, lo, hi)
    return (image - lo) / (hi - lo) * (to_span[1] - to_span[0]) + to_span[0]


def windowing_np(image, from_span=(-1150, 350), to_span=(0, 255)):
    """NumPy twin of `windowing`; `from_span` None takes the image's own
    min and max."""
    if from_span is None:
        lo, hi = np.min(image), np.max(image)
    else:
        lo, hi = from_span
    image = np.clip(image, lo, hi)
    return ((image - lo) / float(hi - lo)) * (to_span[1] - to_span[0]) \
        + to_span[0]


def otsu_threshold_u8(values, mask=None):
    """Otsu threshold of values in [0, 255] (floored to u8 bins) within
    `mask`; returns a 0-d float64 tensor holding a bin value. A single
    observed value is its own threshold; an empty mask gives 255. The
    cut statistics run in float64 (the JAX package runs them in f32)."""
    return _otsu_u8(values, mask)[0]


def _otsu_u8(values, mask):
    """(`otsu_threshold_u8`, whether the masked values fill one bin)."""
    v = torch.floor(torch.clamp(values, 0.0, 255.0)).to(torch.int64)
    if mask is not None:
        v = torch.where(mask.bool(), v, torch.full_like(v, 256))
    counts = torch.bincount(v.reshape(-1), minlength=257)[:256] \
        .to(torch.float64)
    centers = torch.arange(256, dtype=torch.float64, device=counts.device)
    big = 1e9
    vmin = torch.where(counts > 0, centers, torch.full_like(centers, big)).min()
    vmax = torch.where(counts > 0, centers, torch.full_like(centers, -big)).max()
    weight1 = torch.cumsum(counts, 0)
    weight2 = torch.flip(torch.cumsum(torch.flip(counts, (0,)), 0), (0,))
    cv = counts * centers
    mean1 = torch.cumsum(cv, 0) / torch.clamp(weight1, min=1e-12)
    mean2 = torch.flip(torch.cumsum(torch.flip(cv, (0,)), 0), (0,)) \
        / torch.clamp(weight2, min=1e-12)
    var12 = weight1[:-1] * weight2[1:] * (mean1[:-1] - mean2[1:]) ** 2
    cut = centers[:-1]
    var12 = torch.where((cut >= vmin) & (cut < vmax), var12,
                        torch.full_like(var12, float("-inf")))
    th = cut[torch.argmax(var12)]
    return (torch.clamp(torch.where(vmin >= vmax, vmin, th), 0.0, 255.0),
            vmin == vmax)


def otsu_threshold_from_hist(counts256):
    """Otsu threshold from a 256-bin histogram of u8 data (skimage's
    algorithm over the observed range); None for an empty histogram."""
    counts256 = np.asarray(counts256, np.float64)
    nz = np.nonzero(counts256)[0]
    if len(nz) == 0:
        return None
    vmin, vmax = int(nz[0]), int(nz[-1])
    if vmin == vmax:
        return float(vmin)
    centers = np.arange(vmin, vmax + 1, dtype=np.float64)
    counts = counts256[vmin:vmax + 1]
    w1 = np.cumsum(counts)
    w2 = np.cumsum(counts[::-1])[::-1]
    m1 = np.cumsum(counts * centers) / w1
    m2 = (np.cumsum((counts * centers)[::-1]) / w2[::-1])[::-1]
    var12 = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
    return float(centers[:-1][np.argmax(var12)])


def otsu_threshold_u8_np(values_u8):
    """Host Otsu threshold of already-quantized u8 data."""
    v = np.asarray(values_u8).astype(np.uint8).ravel()
    return otsu_threshold_from_hist(np.bincount(v, minlength=256))


def binary_cam_np(values, scaler=1.0, from_span=(0, 1)):
    """Host CAM threshold (the reference's binary_cam): window to u8,
    Otsu, scale by `scaler` and cap at 255; returns (mask, threshold in
    [0, 1]). A single observed value is its own threshold."""
    values = np.asarray(values)
    if values.size == 0:
        raise ValueError("empty array encountered! values.size == 0.")
    w = windowing_np(values, from_span=from_span, to_span=(0, 255)) \
        .astype(np.uint8)
    uniq = np.unique(w)
    if len(uniq) < 2:
        return np.ones_like(w, bool), float(uniq[0]) / 255.0
    th = min(otsu_threshold_u8_np(w) * scaler, 255.0)
    return w >= th, th / 255.0


def find_crops_np(mask, spacing, border):
    """Bounding box of mask > 0 padded by ceil(border / spacing) voxels a
    side (border in mm), clamped to the volume: a tuple of slices."""
    mask = np.asarray(mask) > 0
    if not mask.any():
        raise ValueError("find_crops_np: empty mask")
    slices = []
    ndim = mask.ndim
    for ax in range(ndim):
        proj = mask.any(axis=tuple(i for i in range(ndim) if i != ax))
        idx = np.where(proj)[0]
        start, stop = int(idx[0]), int(idx[-1]) + 1
        if border > 0:
            pad = int(np.ceil(border / float(spacing[ax])))
            start = max(0, start - pad)
            stop = min(mask.shape[ax], stop + pad)
        slices.append(slice(start, stop))
    return tuple(slices)


def binary_cam_threshold(values01, mask=None, scaler=1.0, from_span=(0, 1)):
    """Threshold (in the [0, 1] domain, f32) of a CAM volume: window
    `from_span` to u8, Otsu within `mask`, times `scaler` capped at 255,
    unless the masked values fill one u8 bin, whose value is then the
    threshold unscaled. An empty mask gives 255 * scaler."""
    w = windowing(values01, from_span=from_span, to_span=(0, 255))
    th, single = _otsu_u8(w, mask)
    th = torch.where(single, th, torch.clamp(th * scaler, max=255.0))
    return th.to(torch.float32) / 255.0


def pooling_dense_features(dense_outs, lungs=None, pooling_method="avg"):
    """Pool dense logits (B, D, H, W, C) to (B, C): "global_avg" /
    "global_max" over every voxel, "avg" (the default) the mean within
    `lungs` (B, D, H, W, 1)."""
    if pooling_method == "global_avg":
        return dense_outs.mean(dim=(1, 2, 3))
    if pooling_method == "global_max":
        return dense_outs.amax(dim=(1, 2, 3))
    lungs = lungs.to(dense_outs.dtype)
    num = (dense_outs * lungs).sum(dim=(1, 2, 3))
    den = lungs.sum(dim=(1, 2, 3)) * torch.ones(
        dense_outs.shape[-1], dtype=dense_outs.dtype,
        device=dense_outs.device)
    return num / den


def masked_mean(x, mask, dims):
    """sum(x * mask) / sum(mask) over `dims` with fixed shapes."""
    m = mask.to(x.dtype)
    return (x * m).sum(dims) / torch.clamp(m.sum(dims), min=1e-12)


def gsum(x, group=None):
    """Sum of every element, then the sum over the ranks of `group`
    (dram_tpu's gsum with `axis_name`): differentiable, its gradient
    the cross-rank sum of the incoming one, as psum transposes to psum.
    With a loss built from gsums every rank holds the global objective,
    and its gradient is the world size times its own rows' share; the
    trainer's gradient mean recovers the global gradient."""
    s = x.sum()
    if group is None:
        return s
    return all_reduce_sum(s, group)


def packbits_u8(mask):
    """Pack a bool/0-1 tensor into u8, np.packbits MSB-first order."""
    flat = (mask.reshape(-1) > 0).to(torch.int32)
    pad = (-flat.shape[0]) % 8
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=flat.device)
    return (flat.reshape(-1, 8) * weights).sum(1).to(torch.uint8)


def unpackbits_u8_dev(packed, shape):
    """Inverse of packbits_u8 on a tensor: u8 (n_bytes,) -> bool `shape`."""
    shifts = torch.tensor([7, 6, 5, 4, 3, 2, 1, 0], dtype=torch.uint8,
                          device=packed.device)
    bits = (packed[:, None] >> shifts) & 1
    n = int(np.prod(shape))
    return (bits.reshape(-1)[:n] > 0).reshape(tuple(shape))


def unpackbits_np(packed, shape):
    """Host inverse of packbits_u8 -> u8 array of `shape`."""
    bits = np.unpackbits(np.asarray(packed, np.uint8))
    return bits[: int(np.prod(shape))].reshape(shape)

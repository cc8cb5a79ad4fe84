"""Host transforms over the `#key` / meta sample-dict contract.

Port of dram_tpu/data/transforms.py: `Compose` (:26), the key predicates
(:36-46), `RemoveMeta` (:48), `Windowing` (:63), `resample_array` (:78)
and `Resample` (:135) in the modes the settings take: "fixed_size"
(RESAMPLE_MODE of the shipped settings) and "fixed_spacing" (the
host-stitch paths' spacing), and the training augmentations:
`GaussianBlur` (:248), `GaussianAddictive` (:261), `RandomMaskOut`
(:282), `RandomFlip` (:319), `RandomRotate90` (:332) and
`ensemble_augmentation` (:685). Samples are dicts whose `#`-prefixed keys
hold arrays and whose `meta` dict carries uid, spacing and size; keys
holding "reference" or "weight_map" resample nearest, the others
linearly. The augmentations draw from the global `np.random`, as the JAX
package's do, so one seed gives both packages' arrays. The other
resample modes and transforms are not ported (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import copy

import numpy as np

from ..core.ops import windowing_np
from ..core.resample import itk_resample3d_np
from ..native import hostprep_native


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


def _is_tensor_key(k):
    return "#" in k


def _is_image_key(k):
    return "#" in k and "image" in k


def _is_reference_key(k):
    return "#" in k and ("reference" in k or "weight_map" in k)


class RemoveMeta:
    """Keep only the meta entries the trainer reads."""

    KEEP = ("uid", "size", "spacing", "slices", "crop_slices",
            "original_spacing", "original_size", "origin", "direction",
            "cle", "pse", "ctss")

    def __call__(self, sample, keep_keys=None):
        keep = keep_keys or self.KEEP
        meta = {k: v for k, v in sample["meta"].items() if k in keep}
        sample = dict(sample)
        sample["meta"] = meta
        return sample


class Windowing:
    """HU clip + rescale of the image keys."""

    def __init__(self, min=-1200, max=600, out_min=0.0, out_max=1.0):
        self.min = min
        self.max = max
        self.out = (out_min, out_max)

    def __call__(self, sample):
        from_span = (self.min, self.max) if self.min is not None else None
        return {k: (windowing_np(v.astype(np.float32), from_span, self.out)
                    if _is_image_key(k) else v)
                for k, v in sample.items()}


def resample_array(v, spacing, require_spacing=None, new_size=None,
                   interpolator="linear", fill_value=0.0):
    """ITK-semantics resample of a (D, H, W) array from z-y-x `spacing` to
    `require_spacing` (or to `new_size`); returns (array, new spacing).
    Integer inputs come back in their dtype, rounded half to even (the
    reference's SimpleITK resample keeps the input's pixel type).

    Linear resamples (in float32) and nearest resamples of u8 / bool
    arrays run on the C++ host prep (dram_tpu_torch.native, the JAX
    package's route, bit for bit; a failed build raises), other nearest
    inputs on the NumPy twin."""
    spacing = np.asarray(spacing, np.float64)
    if require_spacing is None:
        if new_size is None:
            raise ValueError("need require_spacing or new_size")
        require_spacing = spacing * np.asarray(v.shape) / np.asarray(new_size)
    require_spacing = np.asarray(require_spacing, np.float64)
    if new_size is not None and tuple(v.shape) == tuple(new_size) \
            and np.allclose(require_spacing, spacing):
        # identity only when the index mapping is the identity too
        return v, tuple(float(s) for s in require_spacing)
    if new_size is None:
        new_size = np.ceil(np.asarray(v.shape) * spacing
                           / require_spacing).astype(int)
    scales = (require_spacing / spacing).tolist()
    out_shape = tuple(int(s) for s in new_size)
    in_dtype = np.asarray(v).dtype
    new_spacing = tuple(float(s) for s in require_spacing)
    if interpolator == "nearest" and in_dtype in (np.uint8, np.bool_):
        return hostprep_native.resample_scales_u8_nearest(
            np.asarray(v).astype(np.uint8), scales, out_shape), new_spacing
    if interpolator == "linear":
        out = hostprep_native.resample_scales_f32(
            np.asarray(v, np.float32), scales, out_shape, fill_value)
    else:
        out = itk_resample3d_np(v, out_shape, scales=scales,
                                method=interpolator, fill_value=fill_value)
    if np.issubdtype(in_dtype, np.integer):
        info = np.iinfo(in_dtype)
        out = np.clip(np.round(out), info.min, info.max).astype(in_dtype)
    return out, new_spacing


class Resample:
    """Resample every `#` key of a sample ("fixed_size": to `size` voxels;
    "fixed_spacing": to `factor` mm, a number or a z-y-x triple)."""

    def __init__(self, mode, factor, size=None):
        if mode not in ("fixed_size", "fixed_spacing"):
            raise NotImplementedError(
                f"Resample mode {mode!r} is not ported (ROADMAP Queue 1 "
                "item 3, data layer)")
        self.mode = mode
        self.factor = factor
        self.size = list(size) if size else None

    def _plan(self, sample):
        spacing = np.asarray(sample["meta"]["spacing"], np.float64)
        if self.mode == "fixed_spacing":
            if isinstance(self.factor, (float, int)):
                return [self.factor] * len(spacing), None
            return list(self.factor), None
        ratios = np.asarray(sample["meta"]["size"]) / np.asarray(self.size)
        return (spacing * ratios).tolist(), self.size[:]

    def __call__(self, sample):
        require_spacing, new_size = self._plan(sample)
        spacing = sample["meta"]["spacing"]
        new_sample = {}
        new_spacing = tuple(require_spacing)
        out_size = new_size
        for k, v in sample.items():
            if not _is_tensor_key(k):
                new_sample[k] = v
                continue
            interp = "nearest" if _is_reference_key(k) else "linear"
            if v.ndim == 4:
                rs = [resample_array(vv, spacing, require_spacing, out_size,
                                     interp) for vv in v]
                nv = np.stack([r[0] for r in rs], axis=0)
                new_spacing = rs[0][1]
            elif v.ndim == 3:
                nv, new_spacing = resample_array(v, spacing, require_spacing,
                                                 out_size, interp)
            else:
                raise NotImplementedError(
                    f"Resample: {k} has {v.ndim} dimensions")
            if _is_reference_key(k):
                nv = nv.astype(v.dtype)
            new_sample[k] = nv
            out_size = nv.shape  # subsequent keys match the first
        meta = copy.deepcopy(sample["meta"])
        meta["size_before_resample"] = meta.get("size")
        meta["spacing"] = tuple(new_spacing)
        meta["size"] = out_size
        new_sample["meta"] = meta
        return new_sample


# --- the training augmentations (reference job_runner.py:561-579) ---------


class GaussianBlur:
    """Gaussian blur of the image keys, sigma fixed (`sigma[0]`) or drawn
    uniformly from `sigma` ("random"). scipy is imported at the call."""

    def __init__(self, sigma, mode="fixed"):
        self.sigma = sigma
        self.mode = mode

    def __call__(self, sample):
        from scipy import ndimage
        s = self.sigma[0] if self.mode == "fixed" else \
            np.random.uniform(self.sigma[0], self.sigma[1])
        return {k: (ndimage.gaussian_filter(v.astype(np.float32), s)
                    if _is_image_key(k) else v)
                for k, v in sample.items()}


class GaussianAddictive:
    """Additive Gaussian noise in the image's own dynamic range: the image
    rescaled to [0, 1], noise of a sigma drawn from `sigma` added,
    clipped, scaled back."""

    def __init__(self, sigma, channel_dim=None):
        self.sigma = sigma
        self.eps = 1e-7

    def _apply(self, data):
        s = np.random.uniform(self.sigma[0], self.sigma[1])
        lo, hi = data.min(), data.max()
        rng_span = hi - lo
        x = (data - lo) / float(rng_span + self.eps)
        x = np.clip(x + np.random.normal(0, s, data.shape), 0.0, 1.0)
        return x * rng_span + lo

    def __call__(self, sample):
        return {k: (self._apply(v.astype(np.float32)) if _is_image_key(k)
                    else v)
                for k, v in sample.items()}


class RandomMaskOut:
    """Cut `times` boxes out of the image keys (centres and sizes drawn as
    fractions of the shape from `region_range` / `region_size`), each
    filled with a constant drawn between the image's minimum and
    maximum."""

    def __init__(self, times=5, region_range=((0.2, 0.8),) * 3,
                 region_size=((0.01, 0.06),) * 3, spatial_dim=3,
                 assign_value=0):
        self.times = times
        self.region_range = region_range
        self.region_size = region_size
        self.spatial_dim = spatial_dim

    def __call__(self, sample):
        shape = next(v for k, v in sample.items()
                     if _is_tensor_key(k)).shape[-self.spatial_dim:]
        centers = [tuple(int(ds * np.random.uniform(*r))
                         for ds, r in zip(shape, self.region_range))
                   for _ in range(self.times)]
        sizes = [tuple(int(np.random.uniform(*rs) * ds)
                       for rs, ds in zip(self.region_size, shape))
                 for _ in range(self.times)]

        def mask_out(data):
            out = data.copy()
            lo, hi = data.min(), data.max()
            for c, s in zip(centers, sizes):
                sl = tuple(slice(max(0, cc - ss // 2),
                                 min(cc + (ss - ss // 2), sp))
                           for cc, sp, ss in zip(c, data.shape[-3:], s))
                out[(Ellipsis,) + sl] = np.random.uniform(lo, hi)
            return out

        return {k: (mask_out(v) if _is_image_key(k) else v)
                for k, v in sample.items()}


class RandomFlip:
    """Flip every `#` key along one random spatial axis."""

    def __init__(self, spatial_dim=3):
        self.spatial_dim = spatial_dim

    def __call__(self, sample):
        ax = -int(np.random.randint(1, self.spatial_dim + 1))
        return {k: (np.flip(v, axis=ax).copy() if _is_tensor_key(k) else v)
                for k, v in sample.items()}


class RandomRotate90:
    """Rotate every `#` key by k * 90 degrees in a random spatial plane."""

    def __init__(self, spatial_dim=3):
        self.spatial_dim = spatial_dim

    def __call__(self, sample):
        from itertools import combinations
        k = int(np.random.randint(0, 4))
        axes = list(combinations([-n for n in range(1, self.spatial_dim + 1)],
                                 2))
        ax = axes[np.random.randint(len(axes))]
        return {key: (np.rot90(v, k=k, axes=ax).copy()
                      if _is_tensor_key(key) else v)
                for key, v in sample.items()}


def ensemble_augmentation(aug_ratio):
    """The training pool (blur, mask-out, flip, rotate, noise) in a random
    order per sample, each applied with probability `aug_ratio` (in steps
    of 0.1)."""
    pool = [
        GaussianBlur((0.3, 0.5), "random"),
        RandomMaskOut(region_range=((0.2, 0.8),) * 3,
                      region_size=((0.01, 0.05),) * 3),
        RandomFlip(3),
        RandomRotate90(3),
        GaussianAddictive((0.01, 0.02)),
    ]

    def augment(sample):
        order = np.random.permutation(len(pool))
        for i in order:
            if np.random.randint(0, 10) < 10 * aug_ratio:
                sample = pool[i](sample)
        return sample

    return augment

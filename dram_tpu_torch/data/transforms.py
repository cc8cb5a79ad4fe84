"""Host transforms over the `#key` / meta sample-dict contract.

Port of dram_tpu/data/transforms.py: `Compose` (:26), the key predicates
(:36-46), `RemoveMeta` (:48), `Windowing` (:63), `resample_array` (:78),
`Resample` (:135) in all thirteen modes of its plan (:147-208), the
training augmentations `GaussianBlur` (:248), `GaussianAddictive` (:261),
`RandomMaskOut` (:282), `RandomFlip` (:319), `RandomRotate90` (:332) and
`ensemble_augmentation` (:685), and the extended zoo (:353-682): the
intensity transforms (inverse, gamma, contrast jitter and stretching,
histogram equalisation, standardisation), the crops and masks, the axis
moves and rotations, the 3-D affine and the slab projections. Samples
are dicts whose `#`-prefixed keys hold arrays and whose `meta` dict
carries uid, spacing and size; keys holding "reference" or "weight_map"
resample (and rotate) nearest, the others linearly. The random
transforms draw from the global `np.random`, as the JAX package's do, so
one seed gives both packages' arrays. scipy is imported inside the
transforms that call it.
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
    """Resample every `#` key of a sample to the spacing (and size) of
    the mode's plan; `factor` and `size` are the mode's parameters (the
    settings' RESAMPLE_SPACING and RESAMPLE_SIZE). The two random modes
    ("random_spacing", "inplane_resolution_z_jittering") draw from the
    global np.random."""

    def __init__(self, mode, factor, size=None):
        self.mode = mode
        self.factor = factor
        self.size = list(size) if size else None

    def _inplane(self, spacing, size):
        """The in-plane spacings that put `size`'s rows and columns on
        self.size's."""
        return [spacing[1] * size[1] / self.size[1],
                spacing[2] * size[2] / self.size[2]]

    def _plan(self, sample):
        """(required z-y-x spacing, output size or None: the grid the
        spacing gives)."""
        spacing = np.asarray(sample["meta"]["spacing"], np.float64)
        size = np.asarray(sample["meta"]["size"])
        mode, factor = self.mode, self.factor
        if mode == "random_spacing":
            f = np.random.uniform(factor[0], factor[1])
            return [f] * len(spacing), None
        if mode == "fixed_factor":
            return (spacing * factor).tolist(), None
        if mode == "fixed_spacing":
            if isinstance(factor, (float, int)):
                return [factor] * len(spacing), None
            return list(factor), None
        if mode == "inplane_spacing_only":
            return [spacing[0], factor[1], factor[2]], None
        if mode == "inplane_resolution_only":
            return ([spacing[0]] + self._inplane(spacing, size),
                    [int(size[0]), self.size[1], self.size[2]])
        if mode == "inplane_resolution_z_spacing":
            return ([factor[0]] + self._inplane(spacing, size),
                    [int(round(size[0] * spacing[0] / factor[0])),
                     self.size[1], self.size[2]])
        if mode == "inplane_resolution_z_jittering":
            z = spacing[0] + np.random.uniform(-factor, factor)
            return ([z] + self._inplane(spacing, size),
                    [int(round(size[0] * spacing[0] / z)), self.size[1],
                     self.size[2]])
        if mode == "inplane_resolution_min_z_spacing":
            if spacing[0] < factor[0]:
                return ([factor[0]] + self._inplane(spacing, size),
                        [int(round(size[0] * spacing[0] / factor[0])),
                         self.size[1], self.size[2]])
            return ([spacing[0]] + self._inplane(spacing, size),
                    [int(size[0]), self.size[1], self.size[2]])
        if mode == "fixed_spacing_min_in_plane_resolution":
            f = [factor] * 3 if not isinstance(factor, (tuple, list)) \
                else factor
            if int(round(size[1] * spacing[1] / f[1])) > self.size[1]:
                return ([spacing[0]] + self._inplane(spacing, size),
                        [int(size[0]), self.size[1], self.size[2]])
            return [spacing[0], f[1], f[2]], None
        if mode == "iso_minimal":
            return [float(spacing.min())] * len(spacing), None
        if mode == "fixed_output_size":
            rs = [spacing[-1] * (size[-1] / self.size[-1])] * len(spacing)
            ns = self.size[:]
            ns[0] = int(round(size[0] * spacing[0] / rs[0]))
            ns[1] = int(round(size[1] * spacing[1] / rs[1]))
            return rs, ns
        if mode == "fixed_size":
            ratios = size / np.asarray(self.size)
            return (spacing * ratios).tolist(), self.size[:]
        if mode == "spacing_size_match":
            return list(factor), self.size[:]
        raise ValueError(f"unknown Resample mode {mode!r}")

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


# --- the extended zoo (reference data_transforms.py:213-1131) -----------


def _images(sample, fn):
    """`fn` on every image key (as float32), the other keys as they are."""
    return {k: (fn(v.astype(np.float32)) if _is_image_key(k) else v)
            for k, v in sample.items()}


def _spatial_shape(sample, n=3):
    return next(v for k, v in sample.items() if _is_tensor_key(k)).shape[-n:]


class IntensityInverse:
    """Mirror the intensities within each image's own range."""

    def __call__(self, sample):
        def inv(v):
            lo, hi = v.min(), v.max()
            return (hi + lo) - v
        return _images(sample, inv)


class GammaTransform:
    """x -> x^g in each image's own range, g drawn from `gamma_range`."""

    def __init__(self, gamma_range=(0.7, 1.5)):
        self.gamma_range = gamma_range

    def __call__(self, sample):
        g = np.random.uniform(*self.gamma_range)

        def apply(v):
            lo, hi = v.min(), v.max()
            x = (v - lo) / max(hi - lo, 1e-7)
            return np.power(x, g) * (hi - lo) + lo
        return _images(sample, apply)


class ContrastJitter:
    """Scale about the mean by a factor drawn from `jitter_range`, clipped
    to the image's range with `if_keep_range`."""

    def __init__(self, jitter_range=(0.75, 1.25), if_keep_range=True,
                 channel_dim=None):
        self.jitter_range = jitter_range
        self.keep = if_keep_range

    def __call__(self, sample):
        f = np.random.uniform(*self.jitter_range)

        def apply(v):
            m = v.mean()
            out = (v - m) * f + m
            if self.keep:
                out = np.clip(out, v.min(), v.max())
            return out
        return _images(sample, apply)


class ContrastStretchingTransform:
    """Stretch the `percentiles` span onto the image's range."""

    def __init__(self, percentiles=(2, 98)):
        self.percentiles = percentiles

    def __call__(self, sample):
        def apply(v):
            p_lo, p_hi = np.percentile(v, self.percentiles)
            return windowing_np(v, (p_lo, p_hi), (v.min(), v.max()))
        return _images(sample, apply)


class HistogramEqual:
    """Histogram equalisation over `nbins` bins, back in the image's
    range."""

    def __init__(self, nbins=256):
        self.nbins = nbins

    def __call__(self, sample):
        def apply(v):
            lo, hi = v.min(), v.max()
            hist, bins = np.histogram(v.ravel(), self.nbins, range=(lo, hi))
            cdf = hist.cumsum().astype(np.float64)
            cdf = cdf / cdf[-1]
            out = np.interp(v.ravel(), bins[:-1], cdf)
            return (out.reshape(v.shape) * (hi - lo) + lo).astype(np.float32)
        return _images(sample, apply)


class StandarizeChannel:
    """Zero mean, unit standard deviation."""

    def __call__(self, sample):
        return _images(sample, lambda v: (v - v.mean()) / max(v.std(), 1e-7))


class CenterCrop:
    """Crop every `#` key to `crop_sizes_ratio` of its spatial extent,
    centred; meta's size follows."""

    def __init__(self, crop_sizes_ratio, spatial_dim=3):
        self.ratio = crop_sizes_ratio
        self.spatial_dim = spatial_dim

    def __call__(self, sample):
        shape = _spatial_shape(sample, self.spatial_dim)
        sizes = [int(s * r) for s, r in zip(shape, self.ratio)]
        sl = (Ellipsis,) + tuple(slice((s - c) // 2, (s - c) // 2 + c)
                                 for s, c in zip(shape, sizes))
        out = {k: (v[sl].copy() if _is_tensor_key(k) else v)
               for k, v in sample.items()}
        meta = copy.deepcopy(sample["meta"])
        meta["size"] = tuple(sizes)
        out["meta"] = meta
        return out


class RandomCrop:
    """A random crop (ratios drawn from `crop_ratio_range`) resampled back
    to the original extent, references nearest."""

    def __init__(self, crop_ratio_range=(0.7, 0.95), spatial_dim=3):
        self.range = crop_ratio_range
        self.spatial_dim = spatial_dim

    def __call__(self, sample):
        shape = _spatial_shape(sample, self.spatial_dim)
        ratios = np.random.uniform(*self.range, size=self.spatial_dim)
        sizes = [max(2, int(s * r)) for s, r in zip(shape, ratios)]
        starts = [np.random.randint(0, s - c + 1)
                  for s, c in zip(shape, sizes)]
        sl = (Ellipsis,) + tuple(slice(st, st + c)
                                 for st, c in zip(starts, sizes))
        out = {}
        for k, v in sample.items():
            if not _is_tensor_key(k):
                out[k] = v
                continue
            interp = "nearest" if _is_reference_key(k) else "linear"
            rs, _ = resample_array(v[sl].astype(np.float32), (1.0,) * 3,
                                   new_size=shape, interpolator=interp)
            out[k] = rs.astype(v.dtype) if _is_reference_key(k) else rs
        return out


def _random_boxes(shape, times, size_range, least):
    """`times` boxes of random size (a fraction of each extent drawn from
    `size_range`, at least `least`) at random starts."""
    boxes = []
    for _ in range(times):
        size = [max(least, int(np.random.uniform(*size_range) * s))
                for s in shape]
        start = [np.random.randint(0, max(1, s - c))
                 for s, c in zip(shape, size)]
        boxes.append((Ellipsis,) + tuple(slice(st, st + c)
                                         for st, c in zip(start, size)))
    return boxes


class RandomCubeMask:
    """`times` random boxes of the image keys set to the image's minimum
    (fill "min") or 0."""

    def __init__(self, times=3, size_range=(0.05, 0.15), fill="min"):
        self.times = times
        self.size_range = size_range
        self.fill = fill

    def __call__(self, sample):
        boxes = _random_boxes(_spatial_shape(sample), self.times,
                              self.size_range, 0)

        def apply(v):
            out = v.copy()
            fill = out.min() if self.fill == "min" else 0
            for b in boxes:
                out[b] = fill
            return out
        return {k: (apply(v) if _is_image_key(k) else v)
                for k, v in sample.items()}


class RandomMaskGaussian:
    """Gaussian noise (`sigma` of the image's standard deviation) added
    in `times` random boxes of the image keys."""

    def __init__(self, times=3, size_range=(0.05, 0.15), sigma=0.1):
        self.times = times
        self.size_range = size_range
        self.sigma = sigma

    def __call__(self, sample):
        boxes = _random_boxes(_spatial_shape(sample), self.times,
                              self.size_range, 1)

        def apply(v):
            out = v.copy().astype(np.float32)
            for b in boxes:
                region = out[b]
                out[b] = region + np.random.normal(
                    0, self.sigma * max(v.std(), 1e-7), region.shape)
            return out
        return {k: (apply(v) if _is_image_key(k) else v)
                for k, v in sample.items()}


class DiskMaskOut:
    """Set the image keys to their minimum outside a centred ellipsoid of
    `radius_ratio` of each extent."""

    def __init__(self, radius_ratio=0.5):
        self.radius_ratio = radius_ratio

    def __call__(self, sample):
        shape = _spatial_shape(sample)
        grids = np.meshgrid(*[np.arange(s) - s / 2 for s in shape],
                            indexing="ij")
        r2 = sum((g / (s * self.radius_ratio / 2 + 1e-7)) ** 2
                 for g, s in zip(grids, shape))
        mask = r2 <= 1.0

        def apply(v):
            out = v.copy()
            out[..., ~mask] = out.min()
            return out
        return {k: (apply(v) if _is_image_key(k) else v)
                for k, v in sample.items()}


class RandomMoveAxis:
    """Permute the spatial axes of every `#` key at random."""

    def __init__(self, spatial_dim=3):
        self.spatial_dim = spatial_dim

    def __call__(self, sample):
        perm = np.random.permutation(self.spatial_dim)
        src = [-n for n in range(1, self.spatial_dim + 1)]
        dst = [src[p] for p in perm]
        return {k: (np.moveaxis(v, src, dst).copy() if _is_tensor_key(k)
                    else v)
                for k, v in sample.items()}


class RandomRotate:
    """Rotate every `#` key by an angle drawn from `angle_range` in the
    `axes` plane (scipy.ndimage.rotate, same shape, edges replicated;
    references nearest, images linear)."""

    def __init__(self, angle_range=(-10, 10), axes=(-2, -1)):
        self.angle_range = angle_range
        self.axes = axes

    def __call__(self, sample):
        from scipy import ndimage
        angle = np.random.uniform(*self.angle_range)
        return {k: (ndimage.rotate(v, angle, axes=self.axes, reshape=False,
                                   order=0 if _is_reference_key(k) else 1,
                                   mode="nearest")
                    if _is_tensor_key(k) else v)
                for k, v in sample.items()}


class RandomRotateInplane90:
    """Rotate every `#` key by k * 90 degrees in the (y, x) plane."""

    def __call__(self, sample):
        k = int(np.random.randint(0, 4))
        return {key: (np.rot90(v, k=k, axes=(-2, -1)).copy()
                      if _is_tensor_key(key) else v)
                for key, v in sample.items()}


class RandomAffineTransform3D:
    """A random rotation (degrees per axis from `rot_range`) times a
    random per-axis scale about the volume's centre
    (scipy.ndimage.affine_transform, edges replicated; references
    nearest, images linear)."""

    def __init__(self, rot_range=(-10, 10), scale_range=(0.9, 1.1)):
        self.rot_range = rot_range
        self.scale_range = scale_range

    def _matrix(self):
        ax, ay, az = np.deg2rad(np.random.uniform(*self.rot_range, 3))
        s = np.random.uniform(*self.scale_range, 3)
        Rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)],
                       [0, np.sin(ax), np.cos(ax)]])
        Ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0],
                       [-np.sin(ay), 0, np.cos(ay)]])
        Rz = np.array([[np.cos(az), -np.sin(az), 0],
                       [np.sin(az), np.cos(az), 0], [0, 0, 1]])
        return (Rx @ Ry @ Rz) * s

    def __call__(self, sample):
        from scipy import ndimage
        M = self._matrix()
        out = {}
        for k, v in sample.items():
            if not _is_tensor_key(k):
                out[k] = v
                continue
            center = np.asarray(v.shape[-3:]) / 2.0
            out[k] = ndimage.affine_transform(
                v, M, offset=center - M @ center,
                order=0 if _is_reference_key(k) else 1, mode="nearest")
        return out


def _trailing_projection(data, slab, axis, reduce_max):
    """The reference's slab projection (data_transforms.py:416-430):
    output slice i is the min (max) over input slices [max(0, i - slab),
    i] along `axis`, a trailing window of slab + 1 clipped at the start.
    A 1-d filter with origin slab // 2 (scipy shifts a positive origin's
    window to lower indices) and edge replication: below slab the
    replicated edge repeats data[0], already in the clipped window."""
    from scipy import ndimage
    filt = ndimage.maximum_filter1d if reduce_max \
        else ndimage.minimum_filter1d
    return filt(data, size=slab + 1, axis=axis, mode="nearest",
                origin=slab // 2)


class MinimalIntensityProjection:
    """Sliding minimum-intensity slab projection of the image keys: per
    call a slab thickness drawn from [lo, hi) and a projection axis from
    `angle`."""

    reduce_max = False

    def __init__(self, slab_thickness=(3, 10), angle=(0, 3)):
        self.slab_thickness = tuple(slab_thickness)
        self.angle = tuple(angle)

    def _draw(self):
        slab = int(np.random.randint(*self.slab_thickness))
        axis = int(np.random.randint(*self.angle))
        return slab, axis

    def __call__(self, sample):
        slab, axis = self._draw()
        return _images(sample, lambda v: _trailing_projection(
            v, slab, axis - 3, self.reduce_max))


class MinimalIntensityAxialProjection(MinimalIntensityProjection):
    """Axial (z only) variant. The reference computes a spacing-scaled
    axial thickness and then projects with the raw slab thickness; the
    defect is kept, as the JAX package keeps it."""

    def __init__(self, slab_thickness=(3, 10)):
        super().__init__(slab_thickness, angle=(0, 1))


class MaximumIntensityProjection(MinimalIntensityProjection):
    """The maximum-intensity counterpart."""

    reduce_max = True


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

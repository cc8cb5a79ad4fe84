"""Host transforms over the `#key` / meta sample-dict contract, as far as
the inference engine builds them.

Port of dram_tpu/data/transforms.py: `Compose` (:26), the key predicates
(:36-46), `Windowing` (:63), `resample_array` (:78, its NumPy branch) and
`Resample` (:135) in the modes the engine's settings take: "fixed_size"
(RESAMPLE_MODE of the shipped settings) and "fixed_spacing" (the
host-stitch path's TEST_RESAMPLE_SPACING). Samples are dicts whose
`#`-prefixed keys hold arrays and whose `meta` dict carries uid, spacing
and size; keys holding "reference" or "weight_map" resample nearest,
the others linearly. The training augmentations and the other resample
modes are not ported (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import copy

import numpy as np

from ..core.ops import windowing_np
from ..core.resample import itk_resample3d_np


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
    reference's SimpleITK resample keeps the input's pixel type)."""
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
    out = itk_resample3d_np(v, out_shape, scales=scales,
                            method=interpolator, fill_value=fill_value)
    if np.issubdtype(in_dtype, np.integer):
        info = np.iinfo(in_dtype)
        out = np.clip(np.round(out), info.min, info.max).astype(in_dtype)
    return out, tuple(float(s) for s in require_spacing)


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

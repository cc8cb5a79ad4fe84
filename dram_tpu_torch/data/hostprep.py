"""Host-side scan preparation: iso resample, lung crop, u8 windowing.

Port of the NumPy branch of dram_tpu/data/hostprep.py (`resample_iso_np`,
`lung_crop` :82, `window8` :102, `prep_scan` :118). Inside one process no
wire encoding is needed, so the iso scan is returned as int16 with the
clipping the 12-bit wire applies (HU in [-2048, 2047], hostprep.pack12).
The C++ host prep of dram_tpu/native is not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import numpy as np

from ..core.resample import itk_resample3d_np


def resample_iso_np(vol, spacing, iso_spacing=1.0, method="linear",
                    fill_value=0.0):
    """Iso-resample a (D, H, W) volume with ITK semantics; returns
    (f32 array, iso shape)."""
    spacing = np.asarray(spacing, np.float64)
    scales = iso_spacing / spacing
    out_size = tuple(int(np.ceil(s / sc)) for s, sc in zip(vol.shape, scales))
    y = itk_resample3d_np(np.asarray(vol, np.float32), out_size,
                          scales=scales.tolist(), method=method,
                          fill_value=fill_value)
    return y.astype(np.float32), out_size


def lung_crop(iso_lobe, border_vox=8, multiple=32):
    """Bounding box of lobe > 0 plus a border, size rounded up to a
    multiple; returns (lo, shape)."""
    lo = np.zeros(3, np.int64)
    hi = np.asarray(iso_lobe.shape, np.int64)
    m = iso_lobe > 0
    if m.any():
        for ax in range(3):
            proj = m.any(axis=tuple(i for i in range(3) if i != ax))
            idx = np.where(proj)[0]
            lo[ax] = max(0, int(idx[0]) - border_vox)
            hi[ax] = min(iso_lobe.shape[ax], int(idx[-1]) + 1 + border_vox)
    size = hi - lo
    size = np.minimum(-(-size // multiple) * multiple,
                      np.asarray(iso_lobe.shape))
    lo = np.minimum(lo, np.asarray(iso_lobe.shape) - size)
    lo = np.maximum(lo, 0)
    return lo.astype(np.int64), tuple(int(s) for s in size)


def window8(iso_scan_int16, span):
    """u8 = round(255 * clip((v - lo) / (hi - lo))) through a 4096-entry
    LUT over HU [-2048, 2047]; returns a flat array."""
    lo, hi = float(span[0]), float(span[1])
    v = np.arange(-2048, 2048, dtype=np.float32)
    lut = np.clip((v - lo) / max(hi - lo, 1e-6), 0.0, 1.0)
    lut = np.round(lut * 255.0).astype(np.uint8)
    idx = (np.clip(iso_scan_int16, -2048, 2047).astype(np.int32) + 2048)
    return lut[idx.reshape(-1)]


def prep_scan(scan_int16, lobe_u8, spacing, iso_spacing=1.0,
              pad_value=-2048, vessel_u8=None):
    """Iso resample (linear scan, nearest labels) + lung crop. Returns a
    dict with the cropped iso scan (int16, clipped to [-2048, 2047]),
    lobe and vessel labels and the crop geometry."""
    iso_scan_f, iso_shape = resample_iso_np(scan_int16, spacing, iso_spacing,
                                            "linear", fill_value=pad_value)
    iso_scan = np.round(iso_scan_f).astype(np.int16)
    iso_lobe_f, _ = resample_iso_np(lobe_u8, spacing, iso_spacing,
                                    "nearest")
    iso_lobe = iso_lobe_f.astype(np.uint8)
    iso_vessel = None
    if vessel_u8 is not None and np.any(vessel_u8):
        v_f, _ = resample_iso_np(vessel_u8, spacing, iso_spacing, "nearest")
        iso_vessel = v_f.astype(np.uint8)
    full_iso_shape = tuple(iso_shape)
    crop_lo, crop_shape = lung_crop(iso_lobe)
    sl = tuple(slice(int(l), int(l) + s) for l, s in zip(crop_lo, crop_shape))
    iso_scan = np.clip(iso_scan[sl], -2048, 2047).astype(np.int16)
    iso_lobe = np.ascontiguousarray(iso_lobe[sl])
    if iso_vessel is not None:
        iso_vessel = np.ascontiguousarray(iso_vessel[sl])
    return {"iso_scan": iso_scan, "iso_lobe": iso_lobe,
            "iso_vessel": iso_vessel, "iso_shape": tuple(crop_shape),
            "full_iso_shape": full_iso_shape,
            "crop_lo": crop_lo.astype(np.int64),
            "spacing": tuple(np.asarray(spacing, np.float64).tolist()),
            "iso_spacing": float(iso_spacing),
            "out_shape": tuple(scan_int16.shape)}

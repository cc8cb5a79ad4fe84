"""Host-side scan preparation: iso resample, lung crop and the wire
encodings.

Port of dram_tpu/data/hostprep.py (`resample_iso_np` :24, `pack12` :37,
`unpack12_np` :57, `pack4` :66, `unpack4_np` :76, `lung_crop` :82,
`window8` :102, `prep_scan` :118). `prep_scan` runs one of two preps, as
the caller asks:

* "native" (the default): the C++ host prep (dram_tpu_torch.native), which
  finds the lung window from sub-grid bounding boxes of the raw lobe volume
  and resamples only inside it;
* "numpy": the NumPy twin, iso resample of the whole grid (float32 BLAS
  matmuls), then the crop. It rounds some voxels 1 HU away from the C++
  resample.

Both return the cropped iso scan as int16 clipped to [-2048, 2047]
(`iso_scan`), its labels (`iso_lobe`, `iso_vessel`) and the scan wire of
FastScanPipeline.process_prepped: 12-bit packed HU ("p12") or, with a
`windowing_span`, the windowed 8-bit wire ("w8"), beside the 4-bit lobe
wire.
"""

from __future__ import annotations

import numpy as np

from ..core.resample import itk_resample3d_np

PREPS = ("native", "numpy")


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


def pack12(values_int16):
    """Pack int16 HU values (clipped to [-2048, 2047]) two into three bytes.

    With u = v + 2048 in [0, 4095] for voxels (v0, v1):
      b0 = u0 >> 4;  b1 = ((u0 & 0xF) << 4) | (u1 >> 8);  b2 = u1 & 0xFF.
    Returns (packed u8, n_values)."""
    v = np.asarray(values_int16).reshape(-1)
    n = v.shape[0]
    u = (np.clip(v, -2048, 2047).astype(np.int32) + 2048).astype(np.uint16)
    if n % 2:
        u = np.concatenate([u, np.zeros(1, np.uint16)])
    u = u.reshape(-1, 2)
    b = np.empty((u.shape[0], 3), np.uint8)
    b[:, 0] = u[:, 0] >> 4
    b[:, 1] = ((u[:, 0] & 0xF) << 4) | (u[:, 1] >> 8)
    b[:, 2] = u[:, 1] & 0xFF
    return b.reshape(-1), n


def unpack12_np(packed, n):
    """Inverse of pack12 -> int16 (n,)."""
    b = np.asarray(packed, np.uint8).reshape(-1, 3).astype(np.int32)
    u0 = (b[:, 0] << 4) | (b[:, 1] >> 4)
    u1 = ((b[:, 1] & 0xF) << 8) | b[:, 2]
    u = np.stack([u0, u1], axis=1).reshape(-1)[:n]
    return (u - 2048).astype(np.int16)


def pack4(labels_u8):
    """Pack labels 0..15 two per byte, b = (l0 << 4) | l1; (packed, n)."""
    v = np.asarray(labels_u8).reshape(-1)
    n = v.shape[0]
    if n % 2:
        v = np.concatenate([v, np.zeros(1, v.dtype)])
    v = v.reshape(-1, 2).astype(np.uint8)
    return ((v[:, 0] << 4) | (v[:, 1] & 0xF)).astype(np.uint8), n


def unpack4_np(packed, n):
    """Inverse of pack4 -> u8 (n,)."""
    b = np.asarray(packed, np.uint8)
    return np.stack([b >> 4, b & 0xF], axis=1).reshape(-1)[:n] \
        .astype(np.uint8)


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


def native_lung_window(lobe_u8, spacing, iso_spacing, n_lobes=5):
    """The C++ prep's lung window: per-lobe inclusive bounding boxes of
    the nearest iso resample of the raw lobe volume (without building
    it), then lung_crop's border and rounding. Returns (mins, maxs,
    present lobes (bool), crop_lo, crop_shape, full iso shape)."""
    from ..native import hostprep_native as hp
    mins, maxs, full_iso_shape = hp.subgrid_bboxes(lobe_u8, spacing,
                                                   iso_spacing, n_lobes)
    have = maxs[:, 0] >= mins[:, 0]
    shape_arr = np.asarray(full_iso_shape, np.int64)
    if have.any():
        lo = np.maximum(mins[have].min(axis=0).astype(np.int64) - 8, 0)
        hi = np.minimum(maxs[have].max(axis=0).astype(np.int64) + 1 + 8,
                        shape_arr)
    else:
        lo, hi = np.zeros(3, np.int64), shape_arr.copy()
    size = np.minimum(-(-(hi - lo) // 32) * 32, shape_arr)
    crop_lo = np.maximum(np.minimum(lo, shape_arr - size), 0)
    return mins, maxs, have, crop_lo, tuple(int(s) for s in size), \
        tuple(full_iso_shape)


def window8(iso_scan_int16, span):
    """u8 = round(255 * clip((v - lo) / (hi - lo))) through a 4096-entry
    LUT over HU [-2048, 2047]; returns a flat array."""
    lo, hi = float(span[0]), float(span[1])
    v = np.arange(-2048, 2048, dtype=np.float32)
    lut = np.clip((v - lo) / max(hi - lo, 1e-6), 0.0, 1.0)
    lut = np.round(lut * 255.0).astype(np.uint8)
    idx = (np.clip(iso_scan_int16, -2048, 2047).astype(np.int32) + 2048)
    return lut[idx.reshape(-1)]


def _prep_native(scan_int16, lobe_u8, spacing, iso_spacing, pad_value,
                 vessel_u8):
    from ..native import hostprep_native as hp
    _, _, _, crop_lo, crop_shape, full_iso_shape = native_lung_window(
        lobe_u8, spacing, iso_spacing)
    iso_lobe = hp.resample_window_labels(lobe_u8, spacing, iso_spacing,
                                         crop_lo, crop_shape)
    iso_scan = hp.resample_window_int16(scan_int16, spacing, iso_spacing,
                                        crop_lo, crop_shape, fill=pad_value)
    iso_vessel = None
    if vessel_u8 is not None and np.any(vessel_u8):
        iso_vessel = hp.resample_window_labels(vessel_u8, spacing,
                                               iso_spacing, crop_lo,
                                               crop_shape)
    return iso_scan, iso_lobe, iso_vessel, crop_lo, crop_shape, \
        full_iso_shape


def _prep_numpy(scan_int16, lobe_u8, spacing, iso_spacing, pad_value,
                vessel_u8):
    iso_scan_f, full_iso_shape = resample_iso_np(
        scan_int16, spacing, iso_spacing, "linear", fill_value=pad_value)
    iso_scan = np.round(iso_scan_f).astype(np.int16)
    iso_lobe = resample_iso_np(lobe_u8, spacing, iso_spacing,
                               "nearest")[0].astype(np.uint8)
    iso_vessel = None
    if vessel_u8 is not None and np.any(vessel_u8):
        iso_vessel = resample_iso_np(vessel_u8, spacing, iso_spacing,
                                     "nearest")[0].astype(np.uint8)
    crop_lo, crop_shape = lung_crop(iso_lobe)
    sl = tuple(slice(int(l), int(l) + s) for l, s in zip(crop_lo, crop_shape))
    iso_scan = np.ascontiguousarray(iso_scan[sl])
    iso_lobe = np.ascontiguousarray(iso_lobe[sl])
    if iso_vessel is not None:
        iso_vessel = np.ascontiguousarray(iso_vessel[sl])
    return iso_scan, iso_lobe, iso_vessel, crop_lo, crop_shape, \
        tuple(full_iso_shape)


def prep_scan(scan_int16, lobe_u8, spacing, iso_spacing=1.0,
              pad_value=-2048, vessel_u8=None, windowing_span=None,
              prep="native"):
    """Iso resample (linear scan, nearest labels) inside the lung window,
    and the wires of FastScanPipeline.process_prepped.

    `prep` is "native" (C++) or "numpy". Returns a dict with the cropped
    iso scan (`iso_scan`, int16 clipped to [-2048, 2047]), lobe and vessel
    labels (`iso_lobe`, `iso_vessel`, also under `iso_lobe_host` and
    `iso_vessel_host`), the crop geometry, and the wires: `packed_scan`
    (`wire` "p12", or "w8" with `windowing_span`), `packed_lobe` and
    `n_voxels`."""
    if prep not in PREPS:
        raise ValueError(f"prep={prep!r}: one of {PREPS}")
    run = _prep_native if prep == "native" else _prep_numpy
    iso_scan, iso_lobe, iso_vessel, crop_lo, crop_shape, full_iso_shape = \
        run(scan_int16, lobe_u8, spacing, iso_spacing, pad_value, vessel_u8)

    if windowing_span is not None:
        packed_scan = window8(iso_scan, windowing_span)
        n, wire = packed_scan.shape[0], "w8"
    elif prep == "native":
        from ..native import hostprep_native as hp
        (packed_scan, n), wire = hp.pack12(iso_scan), "p12"
    else:
        (packed_scan, n), wire = pack12(iso_scan), "p12"
    if prep == "native":
        from ..native import hostprep_native as hp
        packed_lobe, _ = hp.pack4(iso_lobe)
    else:
        packed_lobe, _ = pack4(iso_lobe)
    np.clip(iso_scan, -2048, 2047, out=iso_scan)
    return {"iso_scan": iso_scan, "iso_lobe": iso_lobe,
            "iso_vessel": iso_vessel,
            "iso_lobe_host": iso_lobe, "iso_vessel_host": iso_vessel,
            "packed_scan": packed_scan, "packed_lobe": packed_lobe,
            "wire": wire,
            "windowing_span": tuple(windowing_span)
            if windowing_span is not None else None,
            "n_voxels": n, "prep": prep,
            "iso_shape": tuple(crop_shape),
            "full_iso_shape": full_iso_shape,
            "crop_lo": np.asarray(crop_lo).astype(np.int64),
            "spacing": tuple(np.asarray(spacing, np.float64).tolist()),
            "iso_spacing": float(iso_spacing),
            "out_shape": tuple(scan_int16.shape)}

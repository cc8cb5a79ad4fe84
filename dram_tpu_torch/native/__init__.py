"""The C++/OpenMP host prep: an on-demand g++ build bound through ctypes.

`hostprep.cpp` is a copy of the JAX package's C++ host prep (iso
resampling, lung-window resampling with the windowed-u8 histogram,
sub-grid bounding boxes, bf16 chunk extraction and the 12-, 4- and 1-bit
wire packing). It is built at first use with the JAX package's flags
(`-O3 -march=native -fopenmp -shared -fPIC`), so both builds take the same
code paths on one host and give the same bits. The library goes to
`dram_tpu_torch/_build/libhostprep_<hash of source and flags>.so`, is
written under a temporary name and `os.replace`d into place under a file
lock, so concurrent processes build it once and a killed build leaves no
half-written library. A failed build or load raises: no caller falls back
to NumPy unless it asks for the NumPy prep itself.

`hostprep_native` holds one wrapper per entry point (the same names and
arguments as the JAX package's binding); each validates dtype and
contiguity in Python before it passes pointers.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hostprep.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
BUILD_TIMEOUT_S = 120
# the SIMD paths hostprep.cpp selects at compile time (`#if defined`)
SIMD_MACROS = ("__AVX512F__", "__AVX512BW__", "__AVX512VBMI__",
               "__AVX512VBMI2__")

_P, _I, _I64, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
    ctypes.c_double
_RESAMPLE = [_P, _I, _I, _I, _D, _D, _D, _I, _I, _I]
_WINDOW = _RESAMPLE + [_I, _I, _I]
SIGNATURES = {
    "resample_iso_linear_i16": _RESAMPLE + [_D, _P],
    "resample_window_linear_i16": _WINDOW + [_D, _P],
    "resample_iso_linear_f32": _RESAMPLE + [_D, _P],
    "resample_iso_nearest_u8": _RESAMPLE + [_P],
    "resample_window_nearest_u8": _WINDOW + [_P],
    "resample_window_w8hist_i16": _WINDOW + [_D, _D, _D, _P, _P, _P, _P],
    "subgrid_bboxes_u8": _RESAMPLE + [_I, _P, _P],
    "pack12_i16": [_P, _I64, _P],
    "pack4_u8": [_P, _I64, _P],
    "unpackbits_u8": [_P, _I64, _P],
    "lobe_bboxes_u8": [_P, _I, _I, _I, _I, _P, _P],
    "crop_copy_u8": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "extract_chunk_w8": [_P, _P, _I, _I, _I, _I, _P, _P, _D, _D, _I, _I, _I,
                         _P],
    "extract_chunk_bf16": [_P, _P, _I, _I, _I, _I, _P, _P, _D, _D, _I, _I,
                           _I, _P],
    "window8_hist_i16": [_P, _P, _I64, _D, _D, _P, _P],
    "cand_bits_u8": [_P, _P, _I64, _D, _P],
    "lobe_bucket_bits_u8": [_P, _I, _I, _I, _P, _I, _I, _I, _I, _P],
    "unpack_nearest_gather_u8": [_P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _P, _P, _P],
}

_lock = threading.Lock()
_lib = None


def library_path():
    h = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS).encode())
    with open(SRC, "rb") as fp:
        h.update(fp.read())
    return os.path.join(BUILD_DIR, f"libhostprep_{h.hexdigest()[:16]}.so")


def _compile(out):
    """g++ the library into a temporary file beside `out`, then rename it
    into place; raise with g++'s stderr on a failure or a timeout."""
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_lib = os.path.join(tmp, "lib.so")
        try:
            res = subprocess.run([CXX, *CXX_FLAGS, SRC, "-o", tmp_lib],
                                 capture_output=True, text=True,
                                 timeout=BUILD_TIMEOUT_S)
        except FileNotFoundError:
            raise RuntimeError(f"{CXX} not found: the C++ host prep of "
                               "dram_tpu_torch cannot be built") from None
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"{CXX} timed out after {BUILD_TIMEOUT_S} s "
                               f"compiling {SRC}") from None
        if res.returncode != 0:
            raise RuntimeError(f"{CXX} failed on {SRC}:\n{res.stderr}")
        os.replace(tmp_lib, out)


def load():
    """The host prep's ctypes library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            os.makedirs(BUILD_DIR, exist_ok=True)
            with open(os.path.join(BUILD_DIR, "hostprep.lock"), "w") as lk:
                fcntl.flock(lk, fcntl.LOCK_EX)
                if not os.path.exists(path):
                    _compile(path)
            lib = ctypes.CDLL(path)
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = None
            # OpenMP's own entry point, reached through the library's
            # libgomp dependency
            lib.omp_set_num_threads.argtypes = [_I]
            lib.omp_set_num_threads.restype = None
            _lib = lib
        return _lib


def set_num_threads(n):
    """OpenMP threads of the calling thread's later host-prep calls."""
    load().omp_set_num_threads(int(n))


def build_report():
    """g++'s version and which of SIMD_MACROS `-march=native` defines on
    this host (the AVX-512 paths compiled into the library)."""
    version = subprocess.run([CXX, "--version"], capture_output=True,
                             text=True, timeout=30).stdout.splitlines()[0]
    macros = subprocess.run(
        [CXX, *CXX_FLAGS[:2], "-dM", "-E", "-x", "c++", os.devnull],
        capture_output=True, text=True, timeout=30).stdout.split()
    return version, {m: m in macros for m in SIMD_MACROS}


def _scales(spacing, iso_spacing):
    return iso_spacing / np.asarray(spacing, np.float64)


def _iso_shape(shape, scales):
    return tuple(int(np.ceil(s / sc)) for s, sc in zip(shape, scales))


def _ints(v):
    return [int(x) for x in v]


class hostprep_native:
    """The C++ host prep's entry points on NumPy arrays."""

    @staticmethod
    def resample_iso_int16(scan, spacing, iso_spacing=1.0, fill=-2048):
        """Linear iso resample of an int16 scan (rounded); returns (array,
        iso shape)."""
        scan = np.ascontiguousarray(scan, np.int16)
        scales = _scales(spacing, iso_spacing)
        out_shape = _iso_shape(scan.shape, scales)
        out = np.empty(out_shape, np.int16)
        load().resample_iso_linear_i16(
            scan.ctypes.data, *_ints(scan.shape), *map(float, scales),
            *out_shape, float(fill), out.ctypes.data)
        return out, out_shape

    @staticmethod
    def resample_window_int16(scan, spacing, iso_spacing, crop_lo,
                              crop_shape, fill=-2048):
        """The iso resample emitted only inside the window at crop_lo of
        crop_shape."""
        scan = np.ascontiguousarray(scan, np.int16)
        scales = _scales(spacing, iso_spacing)
        out = np.empty(tuple(_ints(crop_shape)), np.int16)
        load().resample_window_linear_i16(
            scan.ctypes.data, *_ints(scan.shape), *map(float, scales),
            *_ints(crop_lo), *_ints(crop_shape), float(fill), out.ctypes.data)
        return out

    @staticmethod
    def resample_window_w8hist(scan, spacing, iso_spacing, crop_lo,
                               crop_shape, lobe_c, span, fill=-2048):
        """resample_window_int16 and window8_hist in one pass: (scan_c
        int16, windowed u8 flat, lung-masked 256-bin histogram)."""
        scan = np.ascontiguousarray(scan, np.int16)
        lobe_c = np.ascontiguousarray(lobe_c, np.uint8)
        scales = _scales(spacing, iso_spacing)
        out = np.empty(tuple(_ints(crop_shape)), np.int16)
        if lobe_c.shape != out.shape:
            raise ValueError(f"lobe_c {lobe_c.shape} != window {out.shape}")
        u8 = np.empty(out.size, np.uint8)
        hist = np.empty(256, np.int64)
        load().resample_window_w8hist_i16(
            scan.ctypes.data, *_ints(scan.shape), *map(float, scales),
            *_ints(crop_lo), *_ints(crop_shape), float(fill),
            float(span[0]), float(span[1]), lobe_c.ctypes.data,
            out.ctypes.data, u8.ctypes.data, hist.ctypes.data)
        return out, u8, hist

    @staticmethod
    def subgrid_bboxes(lobe, spacing, iso_spacing, n_labels):
        """Per-label inclusive (mins, maxs) of the nearest iso resample of
        `lobe`, without building it; returns (mins, maxs, iso shape)."""
        lobe = np.ascontiguousarray(lobe, np.uint8)
        scales = _scales(spacing, iso_spacing)
        out_shape = _iso_shape(lobe.shape, scales)
        mins = np.empty((n_labels, 3), np.int32)
        maxs = np.empty((n_labels, 3), np.int32)
        load().subgrid_bboxes_u8(
            lobe.ctypes.data, *_ints(lobe.shape), *map(float, scales),
            *out_shape, int(n_labels), mins.ctypes.data, maxs.ctypes.data)
        return mins, maxs, out_shape

    @staticmethod
    def resample_window_labels(lobe, spacing, iso_spacing, crop_lo,
                               crop_shape):
        """Nearest label resample inside the window at crop_lo."""
        lobe = np.ascontiguousarray(lobe, np.uint8)
        scales = _scales(spacing, iso_spacing)
        out = np.empty(tuple(_ints(crop_shape)), np.uint8)
        load().resample_window_nearest_u8(
            lobe.ctypes.data, *_ints(lobe.shape), *map(float, scales),
            *_ints(crop_lo), *_ints(crop_shape), out.ctypes.data)
        return out

    @staticmethod
    def resample_iso_labels(lobe, spacing, iso_spacing=1.0):
        lobe = np.ascontiguousarray(lobe, np.uint8)
        scales = _scales(spacing, iso_spacing)
        out = np.empty(_iso_shape(lobe.shape, scales), np.uint8)
        load().resample_iso_nearest_u8(
            lobe.ctypes.data, *_ints(lobe.shape), *map(float, scales),
            *_ints(out.shape), out.ctypes.data)
        return out

    @staticmethod
    def resample_scales_f32(vol, scales, out_shape, fill=0.0):
        """Trilinear resample of a float32 volume by per-axis scales."""
        vol = np.ascontiguousarray(vol, np.float32)
        out = np.empty(tuple(_ints(out_shape)), np.float32)
        load().resample_iso_linear_f32(
            vol.ctypes.data, *_ints(vol.shape), *map(float, scales),
            *_ints(out.shape), float(fill), out.ctypes.data)
        return out

    @staticmethod
    def resample_scales_u8_nearest(vol, scales, out_shape):
        vol = np.ascontiguousarray(vol, np.uint8)
        out = np.empty(tuple(_ints(out_shape)), np.uint8)
        load().resample_iso_nearest_u8(
            vol.ctypes.data, *_ints(vol.shape), *map(float, scales),
            *_ints(out.shape), out.ctypes.data)
        return out

    @staticmethod
    def pack12(values_int16):
        """12-bit wire (data.hostprep.pack12's layout); (packed, n)."""
        v = np.ascontiguousarray(values_int16, np.int16).reshape(-1)
        n = v.shape[0]
        out = np.empty(((n + 1) // 2) * 3, np.uint8)
        load().pack12_i16(v.ctypes.data, n, out.ctypes.data)
        return out, n

    @staticmethod
    def pack4(labels_u8):
        """4-bit label wire (data.hostprep.pack4's layout); (packed, n)."""
        v = np.ascontiguousarray(labels_u8, np.uint8).reshape(-1)
        n = v.shape[0]
        out = np.empty((n + 1) // 2, np.uint8)
        load().pack4_u8(v.ctypes.data, n, out.ctypes.data)
        return out, n

    @staticmethod
    def lobe_bboxes(lobe_u8, n_labels):
        """Per-label inclusive (mins, maxs); an absent label has min >
        max."""
        v = np.ascontiguousarray(lobe_u8, np.uint8)
        mins = np.empty((n_labels, 3), np.int32)
        maxs = np.empty((n_labels, 3), np.int32)
        load().lobe_bboxes_u8(v.ctypes.data, *_ints(v.shape), int(n_labels),
                              mins.ctypes.data, maxs.ctypes.data)
        return mins, maxs

    @staticmethod
    def _chunk(fn, dtype, scan_i16, lobe_u8, label, lo3, size3, span,
               chunk_size):
        scan = np.ascontiguousarray(scan_i16, np.int16)
        lobe = np.ascontiguousarray(lobe_u8, np.uint8)
        if lobe.shape != scan.shape:
            raise ValueError(f"lobe {lobe.shape} != scan {scan.shape}")
        lo3 = np.ascontiguousarray(lo3, np.int32)
        size3 = np.ascontiguousarray(size3, np.int32)
        out = np.empty(tuple(_ints(chunk_size)), dtype)
        getattr(load(), fn)(
            scan.ctypes.data, lobe.ctypes.data, *_ints(scan.shape),
            int(label), lo3.ctypes.data, size3.ctypes.data,
            float(span[0]), float(span[1]), *_ints(chunk_size),
            out.ctypes.data)
        return out

    @staticmethod
    def extract_chunk_w8(scan_i16, lobe_u8, label, lo3, size3, span,
                         chunk_size):
        """One lobe's masked, windowed chunk resized to chunk_size, as
        rounded u8."""
        return hostprep_native._chunk("extract_chunk_w8", np.uint8, scan_i16,
                                      lobe_u8, label, lo3, size3, span,
                                      chunk_size)

    @staticmethod
    def extract_chunk_bf16(scan_i16, lobe_u8, label, lo3, size3, span,
                           chunk_size):
        """extract_chunk_w8's lossless twin: the chunk as bf16 bits (u16)
        of the windowed value in [0, 1]."""
        return hostprep_native._chunk("extract_chunk_bf16", np.uint16,
                                      scan_i16, lobe_u8, label, lo3, size3,
                                      span, chunk_size)

    @staticmethod
    def window8_hist(scan_i16, lobe_u8, span):
        """(windowed u8 flat, 256-bin histogram over lobe > 0)."""
        scan = np.ascontiguousarray(scan_i16, np.int16)
        lobe = np.ascontiguousarray(lobe_u8, np.uint8)
        if lobe.size != scan.size:
            raise ValueError(f"lobe {lobe.shape} != scan {scan.shape}")
        u8 = np.empty(scan.size, np.uint8)
        hist = np.empty(256, np.int64)
        load().window8_hist_i16(scan.ctypes.data, lobe.ctypes.data,
                                scan.size, float(span[0]), float(span[1]),
                                u8.ctypes.data, hist.ctypes.data)
        return u8, hist

    @staticmethod
    def cand_bits(u8, vessel_u8, threshold):
        """packbits(u8 > threshold, vessels excluded)."""
        u = np.ascontiguousarray(u8, np.uint8).reshape(-1)
        v = None if vessel_u8 is None else \
            np.ascontiguousarray(vessel_u8, np.uint8).reshape(-1)
        if v is not None and v.size != u.size:
            raise ValueError(f"vessel {v.size} != u8 {u.size}")
        bits = np.empty((u.size + 7) // 8, np.uint8)
        load().cand_bits_u8(u.ctypes.data, None if v is None else v.ctypes.data,
                            u.size, float(threshold), bits.ctypes.data)
        return bits

    @staticmethod
    def lobe_bucket_bits(lobe_u8, starts, bucket, n_labels):
        """packbits of the (n_labels, *bucket) masks lobe == label + 1 at
        each label's start."""
        lobe = np.ascontiguousarray(lobe_u8, np.uint8)
        starts = np.ascontiguousarray(starts, np.int32)
        total = int(n_labels) * int(np.prod(bucket))
        bits = np.empty((total + 7) // 8, np.uint8)
        load().lobe_bucket_bits_u8(
            lobe.ctypes.data, *_ints(lobe.shape), starts.ctypes.data,
            *_ints(bucket), int(n_labels), bits.ctypes.data)
        return bits

    @staticmethod
    def crop_copy(vol_u8, lo3, size3):
        """Contiguous copy of the window at lo3 of size3."""
        vol = np.ascontiguousarray(vol_u8, np.uint8)
        out = np.empty(tuple(_ints(size3)), np.uint8)
        load().crop_copy_u8(vol.ctypes.data, *_ints(vol.shape), *_ints(lo3),
                            *_ints(size3), out.ctypes.data)
        return out

    @staticmethod
    def unpackbits(packed, shape):
        p = np.ascontiguousarray(packed, np.uint8).reshape(-1)
        out = np.empty(p.shape[0] * 8, np.uint8)
        load().unpackbits_u8(p.ctypes.data, p.shape[0], out.ctypes.data)
        return out[: int(np.prod(shape))].reshape(shape)

    @staticmethod
    def unpack_nearest_gather(packed, iso_shape, out_full, window_lo,
                              window_shape, tables):
        """Unpack a packed iso-crop mask and nearest-gather it by per-axis
        index tables into out_full's window (written in place)."""
        p = np.ascontiguousarray(packed, np.uint8).reshape(-1)
        if out_full.dtype != np.uint8 or not out_full.flags.c_contiguous:
            raise ValueError("out_full must be a C-contiguous uint8 array")
        if p.size * 8 < int(np.prod(iso_shape)):
            raise ValueError("packed mask shorter than iso_shape")
        iz, iy, ix = [np.ascontiguousarray(t, np.int32) for t in tables]
        if (len(iz), len(iy), len(ix)) != tuple(_ints(window_shape)):
            raise ValueError("tables do not match window_shape")
        load().unpack_nearest_gather_u8(
            p.ctypes.data, *_ints(iso_shape), out_full.ctypes.data,
            int(out_full.shape[1]), int(out_full.shape[2]),
            *_ints(window_lo), *_ints(window_shape),
            iz.ctypes.data, iy.ctypes.data, ix.ctypes.data)
        return out_full

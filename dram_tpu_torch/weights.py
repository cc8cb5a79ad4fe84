"""Flagship weights: a reader for the flax msgpack checkpoint and the
mapping from the flax parameter tree to the port's state_dict.

`assets/bench_weights.ckpt.xz` is an lzma-compressed flax msgpack of
{"params": ..., "batch_stats": ...} (written by tools/export_bench_weights.py,
read in the JAX package by bench.py:68-98 through
flax.serialization.msgpack_restore). Its arrays are flax ext type 1: the
msgpack of (shape, dtype name, raw bytes); numpy scalars are ext type 3,
the same payload. The reader below covers the msgpack subset such a file
and dram_tpu's checkpoints use (maps, arrays, str, bin, nil, booleans,
ints, floats and ext types 1 and 3), so the port needs neither msgpack
nor flax; `msgpack_packb` is its inverse, byte for byte what
flax.serialization.msgpack_serialize writes for a tree of dicts, lists,
Python scalars and arrays under 1 GiB.

`from_jax` is the inverse of dram_tpu/train/torch_import.py:13-33, with the
key mapping of tests/test_reference_parity.py:186-232: conv kernels
(kd, kh, kw, Ci, Co) of any size become (Co, Ci, kd, kh, kw), dense
kernels (in, out) become (out, in), BN and GroupNorm scale/bias become
weight/bias, BN mean/var running_mean/running_var (the 'bnt' and
'bntna' norms' too), conv biases and PReLU's scalar negative_slope keep
their names; module names are kept, joined with dots. `to_jax` maps the
port's state (or its gradients, by parameter name) back into flax-named
trees, so that tests compare by name. `load_backbone` loads the trained
flagship's DC3D backbone (st_dram_ref's widths and names) into a DC3D.
"""

from __future__ import annotations

import lzma
import os
import struct

import numpy as np
import torch

DEFAULT_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "bench_weights.ckpt.xz")

# flax serialization's ext codes: ndarray, numpy scalar
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _ext(code, data):
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"msgpack ext type {code} is not a flax ndarray")
    shape, dtype, raw = msgpack_unpackb(data)
    a = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
    return a[()] if code == _EXT_NPSCALAR else a


# fixed-width formats: byte -> (struct format, kind)
_FIXED = {0xca: (">f", "v"), 0xcb: (">d", "v"),
          0xcc: (">B", "v"), 0xcd: (">H", "v"), 0xce: (">I", "v"),
          0xcf: (">Q", "v"), 0xd0: (">b", "v"), 0xd1: (">h", "v"),
          0xd2: (">i", "v"), 0xd3: (">q", "v"),
          0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
          0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
          0xdc: (">H", "arr"), 0xdd: (">I", "arr"),
          0xde: (">H", "map"), 0xdf: (">I", "map"),
          0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_CONST = {0xc0: None, 0xc2: False, 0xc3: True}


def _read(buf, pos):
    b = buf[pos]
    pos += 1
    if b <= 0x7f:
        return b, pos
    if b >= 0xe0:
        return b - 0x100, pos
    if b in _CONST:
        return _CONST[b], pos
    if 0x80 <= b <= 0x8f:
        return _items(buf, pos, b & 0x0f, "map")
    if 0x90 <= b <= 0x9f:
        return _items(buf, pos, b & 0x0f, "arr")
    if 0xa0 <= b <= 0xbf:
        n = b & 0x1f
        return bytes(buf[pos:pos + n]).decode(), pos + n
    if b in _FIXEXT:
        n = _FIXEXT[b]
        code = struct.unpack_from(">b", buf, pos)[0]
        return _ext(code, bytes(buf[pos + 1:pos + 1 + n])), pos + 1 + n
    if b not in _FIXED:
        raise ValueError(f"msgpack byte 0x{b:02x} at {pos - 1} not supported")
    fmt, kind = _FIXED[b]
    v = struct.unpack_from(fmt, buf, pos)[0]
    pos += struct.calcsize(fmt)
    if kind == "v":
        return v, pos
    if kind == "bin":
        return bytes(buf[pos:pos + v]), pos + v
    if kind == "str":
        return bytes(buf[pos:pos + v]).decode(), pos + v
    if kind == "ext":
        code = struct.unpack_from(">b", buf, pos)[0]
        return _ext(code, bytes(buf[pos + 1:pos + 1 + v])), pos + 1 + v
    return _items(buf, pos, v, kind)


def _items(buf, pos, n, kind):
    out = []
    for _ in range(n * (2 if kind == "map" else 1)):
        item, pos = _read(buf, pos)
        out.append(item)
    if kind == "map":
        return dict(zip(out[0::2], out[1::2])), pos
    return out, pos


def msgpack_unpackb(data):
    """Decode one msgpack object (flax array ext types -> ndarrays)."""
    buf = memoryview(data)
    obj, pos = _read(buf, 0)
    if pos != len(buf):
        raise ValueError(f"msgpack: {len(buf) - pos} trailing bytes")
    return obj


def _sized(n, small, formats):
    """The header of a length-`n` item: `small` | n when it fits under
    16 (fixmap, fixarray) or 32 (fixstr), else the first (byte, struct
    format) of `formats` wide enough."""
    if small is not None and n < (32 if small == 0xa0 else 16):
        return bytes([small | n])
    for byte, fmt in formats:
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([byte]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


def _int(v):
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for byte, fmt in ((0xcc, ">B"), (0xcd, ">H"), (0xce, ">I"),
                          (0xcf, ">Q")):
            if v < 1 << (8 * struct.calcsize(fmt)):
                return bytes([byte]) + struct.pack(fmt, v)
    for byte, fmt in ((0xd0, ">b"), (0xd1, ">h"), (0xd2, ">i"),
                      (0xd3, ">q")):
        if v >= -(1 << (8 * struct.calcsize(fmt) - 1)):
            return bytes([byte]) + struct.pack(fmt, v)
    raise ValueError(f"msgpack: integer {v} out of range")


def _pack_ext(code, payload):
    n = len(payload)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    head = bytes([fixed[n]]) if n in fixed else \
        _sized(n, None, ((0xc7, ">B"), (0xc8, ">H"), (0xc9, ">I")))
    return head + struct.pack(">b", code) + payload


def _pack(obj, out):
    if obj is None or isinstance(obj, bool):
        out.append(bytes([{None: 0xc0, False: 0xc2, True: 0xc3}[obj]]))
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode()
        out.append(_sized(len(raw), 0xa0, ((0xd9, ">B"), (0xda, ">H"),
                                            (0xdb, ">I"))) + raw)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_sized(len(obj), None, ((0xc4, ">B"), (0xc5, ">H"),
                                            (0xc6, ">I"))) + bytes(obj))
    elif isinstance(obj, dict):
        out.append(_sized(len(obj), 0x80, ((0xde, ">H"), (0xdf, ">I"))))
        for k, v in sorted(obj.items()):
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_sized(len(obj), 0x90, ((0xdc, ">H"), (0xdd, ">I"))))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        scalar = isinstance(obj, np.generic)
        a = np.asarray(obj)
        if a.dtype.hasobject or a.dtype.isalignedstruct:
            raise ValueError(f"msgpack: arrays of {a.dtype} not supported")
        payload = msgpack_packb((a.shape, a.dtype.name, a.tobytes("C")))
        out.append(_pack_ext(_EXT_NPSCALAR if scalar else _EXT_NDARRAY,
                             payload))
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def msgpack_packb(obj):
    """Encode one object: dicts (in sorted key order, as flax's tree
    flattening leaves them), lists and tuples, None, booleans, ints,
    floats, str, bytes, and numpy arrays and scalars as flax's ndarray /
    scalar ext types (the inverse of msgpack_unpackb)."""
    out = []
    _pack(obj, out)
    return b"".join(out)


def load_bench_weights(path=DEFAULT_PATH):
    """(params, batch_stats) of the trained flagship as nested dicts of
    numpy arrays; floating params cast to f32 (bench.py:86-89)."""
    with open(path, "rb") as fp:
        tree = msgpack_unpackb(lzma.decompress(fp.read()))

    def f32(t):
        if isinstance(t, dict):
            return {k: f32(v) for k, v in t.items()}
        return t.astype(np.float32) if np.issubdtype(t.dtype, np.floating) \
            else t
    return f32(tree["params"]), tree["batch_stats"]


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def from_jax(params, batch_stats):
    """flax (params, batch_stats) -> the port's state_dict of tensors."""
    sd = {}
    for path, a in _flatten(params):
        mod, leaf = ".".join(path[:-1]), path[-1]
        if leaf == "kernel":
            # conv (kd, kh, kw, Ci, Co) -> (Co, Ci, kd, kh, kw);
            # dense (in, out) -> (out, in)
            a = a.transpose(4, 3, 0, 1, 2) if a.ndim == 5 else a.T
            name = "weight"
        elif leaf == "scale":
            name = "weight"
        elif leaf in ("bias", "negative_slope"):
            name = leaf
        else:
            raise KeyError(f"unexpected flax param {'/'.join(path)}")
        sd[f"{mod}.{name}"] = torch.from_numpy(np.array(a))
    for path, a in _flatten(batch_stats):
        if path[-1] not in _STAT_NAMES:
            raise KeyError(f"unexpected flax batch stat {'/'.join(path)}")
        sd[".".join(path[:-1]) + "." + _STAT_NAMES[path[-1]]] = \
            torch.from_numpy(np.array(a))
    return sd


def load_into(model, params, batch_stats):
    """Copy a flax tree into `model` (strict: every key must match)."""
    model.load_state_dict(from_jax(params, batch_stats), strict=True)
    return model


_STAT_LEAVES = {v: k for k, v in _STAT_NAMES.items()}


def flax_path(name, ndim):
    """The flax tree path of the port's tensor `name` of `ndim`
    dimensions: its module names, then the flax leaf (conv and dense
    weights "kernel", norm weights "scale", running statistics "mean" /
    "var", biases and PReLU's "negative_slope" as they are)."""
    *mods, leaf = name.split(".")
    if leaf in _STAT_LEAVES:
        leaf = _STAT_LEAVES[leaf]
    elif leaf == "weight":
        leaf = "kernel" if ndim in (2, 5) else "scale"
    elif leaf not in ("bias", "negative_slope"):
        raise KeyError(f"unexpected tensor {name}")
    return tuple(mods) + (leaf,)


def to_jax(state):
    """The port's tensors by name (a state_dict, or {name: grad} of the
    parameters) -> flax (params, batch_stats) nested dicts of f32 numpy
    arrays; the inverse of from_jax."""
    params, batch_stats = {}, {}
    for name, t in state.items():
        a = t.detach().float().cpu().numpy()
        *mods, leaf = flax_path(name, a.ndim)
        tree = batch_stats if name.split(".")[-1] in _STAT_LEAVES \
            else params
        if leaf == "kernel" and a.ndim == 5:
            a = a.transpose(2, 3, 4, 1, 0)  # (Co, Ci, k, k, k) -> flax
        elif leaf == "kernel":
            a = a.T  # dense (out, in) -> (in, out)
        for m in mods:
            tree = tree.setdefault(m, {})
        # a copy: a CPU tensor's .numpy() shares its memory, and the
        # tree must not move when the parameter does
        tree[leaf] = np.array(a, order="C")
    return params, batch_stats


def load_backbone(model, path=DEFAULT_PATH):
    """Copy the trained flagship's `backbone` subtree (a DC3D at
    st_dram_ref's published widths, dram_tpu/models/dc3d_at.py:64) into
    the DC3D `model`."""
    params, batch_stats = load_bench_weights(path)
    return load_into(model, params["backbone"], batch_stats["backbone"])

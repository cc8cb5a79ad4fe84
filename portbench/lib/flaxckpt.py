"""The trained flagship's weights: a frozen copy of the port's reader of
the flax msgpack checkpoint (dram_tpu_torch/weights.py: msgpack_unpackb,
load_bench_weights, from_jax) so that the benchmark, not the program,
reads the file and hands the same tensors to the port and to the
reference. Names are the port's state_dict names (the flax tree's module
names joined with dots; conv kernels (Co, Ci, k, k, k), dense (out,
in), BN scale/bias as weight/bias, mean/var as running_mean/running_var).
"""

import lzma
import struct

import numpy as np

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


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def state_dict_np(path):
    """{port tensor name: f32 numpy array} of a flax msgpack checkpoint
    ({"params", "batch_stats"}, lzma-compressed)."""
    with open(path, "rb") as fp:
        tree = msgpack_unpackb(lzma.decompress(fp.read()))
    sd = {}
    for p, a in _flatten(tree["params"]):
        mod, leaf = ".".join(p[:-1]), p[-1]
        if leaf == "kernel":
            a = a.transpose(4, 3, 0, 1, 2) if a.ndim == 5 else a.T
            name = "weight"
        elif leaf == "scale":
            name = "weight"
        elif leaf in ("bias", "negative_slope"):
            name = leaf
        else:
            raise KeyError(f"unexpected flax param {'/'.join(p)}")
        sd[f"{mod}.{name}"] = np.ascontiguousarray(a, np.float32)
    for p, a in _flatten(tree["batch_stats"]):
        if p[-1] not in _STAT_NAMES:
            raise KeyError(f"unexpected flax batch stat {'/'.join(p)}")
        sd[".".join(p[:-1]) + "." + _STAT_NAMES[p[-1]]] = \
            np.ascontiguousarray(a, np.float32)
    return sd

"""Checkpoints: flax msgpack trees with a tolerant, shape-checked restore.

Port of dram_tpu/train/checkpoint.py (`save_checkpoint` :20,
`load_checkpoint` :30, `newest_checkpoint` :35, `tolerant_merge` :58) in
the same format, flax msgpack of nested dicts of arrays, read and written
by the port's own codec (weights.msgpack_unpackb / msgpack_packb), so
that dram_tpu's checkpoints load in the port and the port's in dram_tpu.
Trees hold flax names and layouts: weights.to_jax maps a model's
state_dict into one, weights.load_into back.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ..weights import msgpack_packb, msgpack_unpackb


def save_checkpoint(path, tree):
    """Atomically write a nested dict of arrays as flax msgpack."""
    data = msgpack_packb(tree)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as fp:
        fp.write(data)
    os.replace(tmp, path)


def load_checkpoint(path):
    with open(path, "rb") as fp:
        return msgpack_unpackb(fp.read())


def newest_checkpoint(exp_path, pattern="*.ckpt"):
    """The checkpoint to resume from in a directory; None if there is none.

    Ranks by the epoch number of a ``{epoch}.ckpt`` stem; files with
    other names rank below every epoch-named one, newest ctime first.
    """
    files = glob.glob(os.path.join(exp_path, pattern))
    if not files:
        return None

    def rank(path):
        stem = os.path.splitext(os.path.basename(path))[0]
        try:
            return (1, int(stem), 0.0)
        except ValueError:
            return (0, 0, os.path.getctime(path))

    return max(files, key=rank)


def tolerant_merge(current, saved, ignored_keys=(), overwrite=False,
                   log=None, _prefix=""):
    """Merge `saved` into `current` (both nested dicts), keeping the
    current entry where the saved one is missing, ignored or of another
    shape (each logged through `log`); with `overwrite`, saved entries
    replace current ones wholesale. Returns a new tree."""
    if overwrite:
        out = dict(current) if isinstance(current, dict) else {}
        out.update(saved)
        return out
    if not isinstance(current, dict) or not isinstance(saved, dict):
        return current
    out = {}
    for k, cv in current.items():
        key = f"{_prefix}{k}"
        if k not in saved:
            out[k] = cv
            continue
        sv = saved[k]
        if key in ignored_keys or k in ignored_keys:
            if log:
                log(f"ignore key: {key}")
            out[k] = cv
        elif isinstance(cv, dict):
            out[k] = tolerant_merge(cv, sv, ignored_keys, False, log,
                                    _prefix=key + "/")
        elif hasattr(cv, "shape"):
            if hasattr(sv, "shape") and \
                    tuple(np.shape(sv)) == tuple(np.shape(cv)):
                out[k] = np.asarray(sv).astype(np.asarray(cv).dtype)
            else:
                if log:
                    log(f"in {key}, saved shape {np.shape(sv)} does not "
                        f"match current shape {np.shape(cv)}")
                out[k] = cv
        else:
            out[k] = sv
    return out

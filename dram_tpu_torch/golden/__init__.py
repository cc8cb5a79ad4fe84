"""Goldens of the JAX package that the port is held against, and the
readings that compare with them.

flagship_scan.npz (tools/make_port_golden.py): dram_tpu's masks of
chip_smoke.py's scan. flagship_train.npz (tools/make_port_train_golden.py):
one training step of dram_tpu's flagship DC3DATGeneric in float64 at the
published widths, from the trained tree, on `train_golden_batch()`. A full
gradient (~16 M values) is too large to keep, so the golden holds per
parameter tensor its gradient's L2 norm and PROJECTIONS seeded
projections (`projections`), the projections of the Adam update, the
train-mode BatchNorm batch statistics of every BN layer and the loss
terms. Keys use the port's parameter names (weights.from_jax).
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from ..data.synth import train_batch

HERE = os.path.dirname(os.path.abspath(__file__))
TRAIN_GOLDEN = os.path.join(HERE, "flagship_train.npz")
# the batch: data/synth.py:train_batch at its default -1000..-300 HU window
TRAIN_SEED, TRAIN_BATCH, TRAIN_SIZE = 0, 2, 48
PROJECTIONS = 16
# flax's BatchNorm: running = MOMENTUM * running + (1 - MOMENTUM) * batch
MOMENTUM = 0.9


def train_golden_batch():
    return train_batch(TRAIN_SEED, batch=TRAIN_BATCH, size=TRAIN_SIZE)


def batch_sha256(batch):
    """SHA-256 of a train_batch's arrays and scores."""
    h = hashlib.sha256()
    for k in ("#image", "#lobe_reference", "#lesion_reference",
              "ctss_frequency"):
        h.update(np.ascontiguousarray(batch[k]).tobytes())
    h.update(np.asarray(batch["meta"]["ctss"], np.int64).tobytes())
    return h.hexdigest()


def _seed(name):
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:8],
                          "little")


def projections(name, a):
    """(PROJECTIONS,) float64: the dot products of `a` (flattened, in the
    port's layout) with PROJECTIONS standard-normal f32 vectors drawn by
    numpy from a seed derived from the tensor's `name`."""
    a = np.asarray(a, np.float64).ravel()
    rng = np.random.default_rng(_seed(name))
    return np.array([np.dot(rng.standard_normal(a.size, np.float32), a)
                     for _ in range(PROJECTIONS)])


def batch_statistics(running, initial):
    """The batch statistic that one train-mode step folded into a
    BatchNorm running statistic: (running - MOMENTUM * initial) /
    (1 - MOMENTUM), float64."""
    r1, r0 = (np.asarray(a, np.float64) for a in (running, initial))
    return (r1 - MOMENTUM * r0) / (1.0 - MOMENTUM)


def zero_in_exact_arithmetic(name):
    """The tap heads' 1x1x1 conv biases: a train-mode BatchNorm follows
    and subtracts the batch mean, so their gradient (and their Adam step)
    is zero in exact arithmetic and holds only rounding."""
    return name.startswith("reshape_") and name.endswith("conv.bias")


def summarize(grads, buffers, initial, params=None, initial_params=None):
    """The golden's fields of one step, port-named numpy float64 values:
    `grads` {parameter: gradient}, `buffers` {BN running statistic after
    the step}, `initial` {the same before it}; with `params` (after the
    step) and `initial_params`, the projections of the update."""
    out = {}
    for n, g in grads.items():
        g = np.asarray(g, np.float64)
        out[f"grad_norm/{n}"] = np.linalg.norm(g.ravel())
        out[f"grad_proj/{n}"] = projections(n, g)
    for n, r in buffers.items():
        out[f"bn/{n}"] = batch_statistics(r, initial[n])
    for n, p in (params or {}).items():
        out[f"update_proj/{n}"] = projections(
            n, np.asarray(p, np.float64)
            - np.asarray(initial_params[n], np.float64))
    return out


def readings(got, gold):
    """Per key of `gold` (a summarize() dict or the golden file) the
    agreement of `got`: {key: (relative L2, cosine, largest |diff| over
    the golden's largest |value|)}. Keys of parameters that are zero in
    exact arithmetic read their absolute size instead: (|got|, nan, nan)."""
    out = {}
    for k in gold:
        if "/" not in k:
            continue
        a = np.atleast_1d(np.asarray(got[k], np.float64))
        b = np.atleast_1d(np.asarray(gold[k], np.float64))
        if zero_in_exact_arithmetic(k.split("/", 1)[1]):
            out[k] = (float(np.abs(a).max()), float("nan"), float("nan"))
            continue
        nb = np.linalg.norm(b)
        cos = float(np.dot(a, b) / max(np.linalg.norm(a) * nb, 1e-300))
        out[k] = (float(np.linalg.norm(a - b) / max(nb, 1e-300)), cos,
                  float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)))
    return out

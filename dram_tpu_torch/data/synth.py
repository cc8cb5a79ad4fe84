"""Synthetic thorax scans and training batches for tests and the chip
smoke run.

`synth_scan` copies dram_tpu/data/prepare_data.py:_synth_scan: air
background, five lobe boxes, one bright cube lesion per lobe whose volume
fraction tracks the lobe's severity score, and a thin vessel plane per
lobe. `train_batch` makes one collated batch of lobe chunks as the
training data pipeline hands it to the trainer's wire packing.
"""

from __future__ import annotations

import numpy as np

from ..core.ops import CTSS_RATIO_LB, CTSS_RATIO_UB


def synth_scan(rng, size, n_lobes=5, lesion_severity=None):
    """Returns (scan int16, lobe u8, lesion u8, vessel u8, severities)."""
    scan = np.full(size, -900, np.int16)
    lobe = np.zeros(size, np.uint8)
    lesion = np.zeros(size, np.uint8)
    vessel = np.zeros(size, np.uint8)
    D, H, W = size
    zs = np.linspace(0, D, n_lobes + 1).astype(int)
    severities = lesion_severity or [int(rng.integers(0, 6))
                                     for _ in range(n_lobes)]
    for li in range(n_lobes):
        z0, z1 = zs[li], zs[li + 1]
        y0, y1 = H // 8, H - H // 8
        x0, x1 = W // 8, W - W // 8
        lobe[z0:z1, y0:y1, x0:x1] = li + 1
        sev = severities[li]
        frac = (CTSS_RATIO_LB[sev] + CTSS_RATIO_UB[sev]) / 2.0
        vol = (z1 - z0) * (y1 - y0) * (x1 - x0)
        target = int(frac * vol)
        if target > 0:
            side = max(1, int(round(target ** (1 / 3))))
            cz = int(rng.integers(z0, max(z0 + 1, z1 - side)))
            cy = int(rng.integers(y0, max(y0 + 1, y1 - side)))
            cx = int(rng.integers(x0, max(x0 + 1, x1 - side)))
            lesion[cz:cz + side, cy:cy + side, cx:cx + side] = 1
        vy = (y0 + y1) // 2
        vessel[z0:z1, vy:vy + 1, x0:x1] = 1
    scan[lobe > 0] = -800
    scan[vessel > 0] = -100
    scan[lesion > 0] = -350
    lesion &= lobe > 0
    # tiled 64^3 noise block: RNG cost independent of the scan size
    tile = rng.normal(0, 10, (min(D, 64), min(H, 64), min(W, 64)))
    reps = [-(-s // t) for s, t in zip(size, tile.shape)]
    noise = np.tile(tile, reps)[:D, :H, :W]
    scan = (scan + noise).astype(np.int16)
    return scan, lobe, lesion, vessel, severities


def train_batch(seed, batch=10, size=80, window=(-1000, -300)):
    """One collated training batch of `batch` lobe chunks of size^3,
    made with numpy from `seed`, in the form dram_tpu's data pipeline
    gives the trainer (dram_tpu/train/trainer.py:pack_train_batch):

    "#image" (B, S, S, S) f32 windowed to [0, 1] from `window` HU;
    "#lobe_reference" u8 lobe mask (an ellipsoid); "#lesion_reference" u8
    intensity lesion candidates (lobe voxels above -700 HU); "meta"
    {"ctss": per-chunk scores 0..5}; "ctss_frequency" (6,) f32, the
    batch's score frequencies (1e-5 for an absent score, as the sampler's
    frequency_array gives them). Each chunk holds lesion blobs covering
    about the middle of its score's ratio interval."""
    rng = np.random.default_rng(seed)
    shape = (batch, size, size, size)
    axis = (np.arange(size) - (size - 1) / 2) / (size / 2)
    z, y, x = np.meshgrid(axis, axis, axis, indexing="ij")
    ctss = rng.integers(0, 6, batch)
    hu = rng.normal(-850.0, 25.0, shape).astype(np.float32)
    lobe = np.zeros(shape, np.uint8)
    for b in range(batch):
        r = rng.uniform(0.7, 0.95, 3)
        inside = (z / r[0]) ** 2 + (y / r[1]) ** 2 + (x / r[2]) ** 2 < 1.0
        lobe[b] = inside
        hu[b][~inside] += 800.0  # soft tissue around the lobe
        frac = (CTSS_RATIO_LB[ctss[b]] + CTSS_RATIO_UB[ctss[b]]) / 2.0
        target = frac * inside.sum()
        lesion = np.zeros(inside.shape, bool)
        voxel = (2.0 / size) ** 3  # a voxel's volume in axis units
        while lesion.sum() < target and target > 0:
            c = rng.uniform(-0.6, 0.6, 3)
            # a sphere of about the missing volume, at most 0.3 across
            need = (target - lesion.sum()) * voxel
            rad = min(0.3, max((3 * need / (4 * np.pi)) ** (1 / 3),
                               3.0 / size)) * rng.uniform(0.7, 1.0)
            lesion |= ((z - c[0]) ** 2 + (y - c[1]) ** 2
                       + (x - c[2]) ** 2 < rad * rad) & inside
        hu[b][lesion] = rng.normal(-400.0, 60.0, int(lesion.sum()))
    lo, hi = window
    image = (np.clip(hu, lo, hi) - lo) / (hi - lo)
    cand = ((hu > -700.0) & (lobe > 0)).astype(np.uint8)
    counts = np.bincount(ctss, minlength=6) / float(batch)
    freq = np.where(counts > 0, counts, 1e-5).astype(np.float32)
    return {"#image": image.astype(np.float32), "#lobe_reference": lobe,
            "#lesion_reference": cand,
            "meta": {"ctss": [int(c) for c in ctss]},
            "ctss_frequency": freq}

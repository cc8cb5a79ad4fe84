"""Synthetic thorax scans for tests and the chip smoke run.

Copy of dram_tpu/data/prepare_data.py:_synth_scan: air background, five
lobe boxes, one bright cube lesion per lobe whose volume fraction tracks
the lobe's severity score, and a thin vessel plane per lobe.
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

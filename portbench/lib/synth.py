"""Synthetic inputs made from the run's seed, on the device in a few
large calls.

`synth_scan` follows dram_tpu_torch/data/synth.py:synth_scan (air
background at -900 HU, five lobe boxes stacked in z at -800, one cube
lesion per lobe at -350 whose volume fraction is the middle of its
severity's CTSS ratio interval, a vessel plane per lobe at -100, a tiled
64^3 block of N(0, 10) noise, truncated to int16). `train_batch` follows
synth.train_batch (lobe ellipsoids in soft tissue, N(-850, 25) HU
parenchyma, lesion spheres of N(-400, 60) HU covering about the middle
of each chunk's CTSS interval, windowed to [0, 1]; the lesion
candidates are the lobe voxels above -700 HU). Draws come from
torch.Generators seeded with the seed, so the same seed gives the same
inputs on the same device."""

import numpy as np
import torch

CTSS_RATIO_LB = np.array([0.0, 0.001, 0.01, 0.05, 0.35, 0.5], np.float32)
CTSS_RATIO_UB = np.array([0.001, 0.01, 0.05, 0.35, 0.5, 1.00001],
                         np.float32)


def _gens(seed, device):
    """(host generator for the small draws, device generator)."""
    seed = int(seed) % (2 ** 63)
    host = torch.Generator().manual_seed(seed)
    dev = torch.Generator(device=device).manual_seed(seed)
    return host, dev


def _randint(gen, lo, hi):
    return int(torch.randint(lo, max(hi, lo + 1), (1,), generator=gen))


def synth_scan(seed, size, severities, device="cuda"):
    """(scan int16, lobe u8) of shape `size` on `device`."""
    host, dev = _gens(seed, device)
    D, H, W = size
    n = len(severities)
    scan = torch.full(size, -900, dtype=torch.int16, device=device)
    lobe = torch.zeros(size, dtype=torch.uint8, device=device)
    zs = np.linspace(0, D, n + 1).astype(int)
    y0, y1, x0, x1 = H // 8, H - H // 8, W // 8, W - W // 8
    cubes, planes = [], []
    for li in range(n):
        z0, z1 = int(zs[li]), int(zs[li + 1])
        lobe[z0:z1, y0:y1, x0:x1] = li + 1
        frac = (CTSS_RATIO_LB[severities[li]]
                + CTSS_RATIO_UB[severities[li]]) / 2.0
        target = int(frac * (z1 - z0) * (y1 - y0) * (x1 - x0))
        if target > 0:
            side = max(1, int(round(target ** (1 / 3))))
            cz = _randint(host, z0, z1 - side)
            cy = _randint(host, y0, y1 - side)
            cx = _randint(host, x0, x1 - side)
            cubes.append((cz, cy, cx, side, z1))
        planes.append((z0, z1, (y0 + y1) // 2))
    inside = lobe > 0
    scan[inside] = -800
    for z0, z1, vy in planes:
        scan[z0:z1, vy:vy + 1, x0:x1] = -100
    for cz, cy, cx, side, z1 in cubes:
        blk = (slice(cz, cz + side), slice(cy, cy + side),
               slice(cx, cx + side))
        scan[blk] = torch.where(inside[blk], torch.full_like(scan[blk], -350),
                                scan[blk])
    tile = torch.randn((min(D, 64), min(H, 64), min(W, 64)), generator=dev,
                       device=device) * 10.0
    reps = [-(-s // t) for s, t in zip(size, tile.shape)]
    noise = tile.repeat(*reps)[:D, :H, :W]
    scan = (scan.float() + noise).to(torch.int16)
    return scan, lobe


def train_batch(seed, batch, size, window, device="cuda"):
    """One training batch on `device`: {"image" (B, S, S, S) f32 in [0, 1],
    "lobe" u8, "lesion" u8 (candidates), "ctss" (B,) int64 scores 0..5,
    "freq" (6,) f32 score frequencies (1e-5 for an absent score)}."""
    host, dev = _gens(seed, device)
    shape = (batch, size, size, size)
    ax = (torch.arange(size, device=device, dtype=torch.float32)
          - (size - 1) / 2) / (size / 2)
    z, y, x = torch.meshgrid(ax, ax, ax, indexing="ij")
    ctss = torch.randint(0, 6, (batch,), generator=host)
    hu = torch.randn(shape, generator=dev, device=device) * 25.0 - 850.0
    lesion_hu = torch.randn(shape, generator=dev, device=device) * 60.0 \
        - 400.0
    radii = torch.rand((batch, 3), generator=host) * 0.25 + 0.7
    lobe = torch.zeros(shape, dtype=torch.bool, device=device)
    lesion = torch.zeros(shape, dtype=torch.bool, device=device)
    voxel = (2.0 / size) ** 3
    for b in range(batch):
        r = radii[b].tolist()
        inside = (z / r[0]) ** 2 + (y / r[1]) ** 2 + (x / r[2]) ** 2 < 1.0
        lobe[b] = inside
        c = int(ctss[b])
        target = float((CTSS_RATIO_LB[c] + CTSS_RATIO_UB[c]) / 2.0) \
            * float(inside.sum())
        have = 0.0
        while have < target:
            cc = (torch.rand(3, generator=host) * 1.2 - 0.6).tolist()
            need = (target - have) * voxel
            rad = min(0.3, max((3 * need / (4 * np.pi)) ** (1 / 3),
                               3.0 / size)) \
                * float(torch.rand(1, generator=host) * 0.3 + 0.7)
            lesion[b] |= ((z - cc[0]) ** 2 + (y - cc[1]) ** 2
                          + (x - cc[2]) ** 2 < rad * rad) & inside
            have = float(lesion[b].sum())
    hu = torch.where(lobe, hu, hu + 800.0)
    hu = torch.where(lesion, lesion_hu, hu)
    lo, hi = float(window[0]), float(window[1])
    image = (torch.clamp(hu, lo, hi) - lo) / (hi - lo)
    cand = (hu > -700.0) & lobe
    counts = torch.bincount(ctss, minlength=6).float() / float(batch)
    freq = torch.where(counts > 0, counts, torch.full_like(counts, 1e-5))
    return {"image": image, "lobe": lobe.to(torch.uint8),
            "lesion": cand.to(torch.uint8), "ctss": ctss.to(device),
            "freq": freq.to(device)}

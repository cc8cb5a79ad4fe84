"""A scan through the reference: the chunk-wire prep, the model on the
five lobe chunks and the post stage, on the device in float32.

Prep (the semantics of the port's NumPy prep, dram_tpu_torch/infer/
fast.py:_prep_chunks_np): SimpleITK's linear resample of the scan to
`iso_spacing` (output voxel i reads input coordinate i * iso / spacing;
points outside [-0.5, n - 0.5) take the pad value; HU rounded to int16)
and its nearest resample of the lobe labels; the lung crop (the lobes'
box plus 8 voxels, sides rounded up to a multiple of 32); per lobe its
box plus ceil(5 mm / iso) voxels, a shared bucket (the largest box's
sides rounded up to a multiple of 16); each lobe windowed to [0, 1]
inside its mask and resized to the chunk (src = i * size / chunk).
Post: the refined logits resized back over the bucket (align corners),
ReLU, each lobe's CAM divided by its maximum over its box, gated by its
predicted lesion ratio >= 0.001, stitched into the iso grid under the
lobe masks; Otsu's threshold of the CAM in 256 bins within the lung;
the mask CAM > threshold. The post rule: the mask AND the intensity
candidate, the crop's HU windowed to u8 (round(255 x clip((HU - lo) /
(hi - lo), 0, 1))) above 0.75 x Otsu's cut of its histogram within the
lung (a single observed value is its own cut, unscaled; an empty lung
passes nothing)."""

import math

import numpy as np
import torch

from . import exact_f32
from .nets import forward
from .quant import QUANTS

RATIO_GATE = 0.001


def _itk_axis(n_in, n_out, scale, device):
    """(n_out, n_in) linear weights, nearest indices and validity."""
    src = np.arange(n_out, dtype=np.float64) * scale
    valid = (src >= -0.5) & (src < n_in - 0.5)
    near = np.clip(np.floor(src + 0.5).astype(np.int64), 0, n_in - 1)
    s = np.clip(src, 0.0, n_in - 1)
    lo = np.floor(s).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    fr = (s - lo).astype(np.float32)
    W = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    np.add.at(W, (rows, lo), (1.0 - fr) * valid)
    np.add.at(W, (rows, hi), fr * valid)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(W), t(near), t(valid)


def iso_resample(scan, lobe, spacing, iso, pad):
    """(iso scan int16, iso labels u8) of device volumes."""
    dev = scan.device
    out = [int(math.ceil(n * s / iso)) for n, s in zip(scan.shape, spacing)]
    y = scan.float()
    lab = lobe
    mask = torch.ones(out, device=dev)
    for ax in range(3):
        W, near, valid = _itk_axis(scan.shape[ax], out[ax],
                                   iso / spacing[ax], dev)
        y = torch.movedim(torch.movedim(y, ax, -1) @ W.T, -1, ax)
        lab = torch.index_select(lab, ax, near)
        shape = [1, 1, 1]
        shape[ax] = -1
        v = valid.reshape(shape)
        lab = lab * v.to(lab.dtype)
        mask = mask * v.float()
    y = y + (1.0 - mask) * pad
    hu = torch.clamp(torch.round(y), -2048, 2047).to(torch.int16)
    return hu, lab


def _box(m, border, shape):
    """Inclusive-exclusive box of a bool volume plus `border`, clamped."""
    lo, hi = [], []
    for ax in range(3):
        proj = m.any(dim=tuple(i for i in range(3) if i != ax))
        idx = torch.nonzero(proj).flatten()
        lo.append(max(0, int(idx[0]) - border))
        hi.append(min(shape[ax], int(idx[-1]) + 1 + border))
    return np.array(lo), np.array(hi)


def _tables(src, n, offset, total):
    s = np.clip(src, 0.0, n - 1)
    lo = np.floor(s).astype(np.int64)
    hi = np.minimum(lo + 1, n - 1)
    fr = (s - lo).astype(np.float32)
    return (np.clip(lo + offset, 0, total - 1),
            np.clip(hi + offset, 0, total - 1), fr)


def _resize(x, tabs, nearest=False):
    """Separable gather resize of (D, H, W) by per-axis (lo, hi, frac)."""
    for ax, (lo, hi, fr) in enumerate(tabs):
        if nearest:
            x = torch.index_select(x, ax, torch.where(fr < 0.5, lo, hi))
            continue
        shape = [1, 1, 1]
        shape[ax] = -1
        f = fr.reshape(shape)
        x = torch.index_select(x, ax, lo) * (1.0 - f) \
            + torch.index_select(x, ax, hi) * f
    return x


def otsu_cut(counts):
    """Otsu's cut of a 256-bin histogram (float64 numpy): the bin index
    that maximises the between-class variance over the observed range,
    the value itself where one bin is filled, None where none is."""
    nz = np.nonzero(counts)[0]
    if len(nz) == 0:
        return None
    vmin, vmax = int(nz[0]), int(nz[-1])
    if vmin == vmax:
        return float(vmin)
    c = np.arange(256, dtype=np.float64)
    w1 = np.cumsum(counts)
    w2 = np.cumsum(counts[::-1])[::-1]
    m1 = np.cumsum(counts * c) / np.maximum(w1, 1e-12)
    m2 = np.cumsum((counts * c)[::-1])[::-1] / np.maximum(w2, 1e-12)
    var = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
    cuts = c[:-1]
    var = np.where((cuts >= vmin) & (cuts < vmax), var, -np.inf)
    return float(cuts[int(np.argmax(var))])


def otsu_threshold(cam, mask):
    """Threshold in [0, 1]: Otsu over floor(255 x clamp(cam, 0, 1)) in
    256 bins within `mask` (the value itself where one bin is filled)."""
    v = torch.floor(torch.clamp(cam[mask], 0.0, 1.0) * 255.0).long()
    cut = otsu_cut(torch.bincount(v, minlength=256).double().cpu().numpy())
    if cut is None:
        return 1.0
    return float(np.float32(cut) / np.float32(255.0))


def candidate(hu, lung, lo_w, hi_w):
    """The post rule's intensity candidate of a HU crop (bool)."""
    u8 = torch.round(torch.clamp((hu.float() - lo_w) / max(hi_w - lo_w, 1e-6),
                                 0.0, 1.0) * 255.0)
    counts = torch.bincount(u8[lung].long(), minlength=256)
    cut = otsu_cut(counts.double().cpu().numpy())
    if cut is None:
        return torch.zeros_like(lung)
    nz = torch.nonzero(counts).flatten()
    th = cut if len(nz) == 1 else min(cut * 0.75, 255.0)
    return u8 > th


def run_scan(scan, lobe, spacing, P, cfg, traffic, quant="exact",
             drop_lobes=()):
    """The reference's answer for one device scan: {"pred" and "post"
    bool on the full iso grid, "ratios" (n_lobes,) numpy}. `drop_lobes` zeroes those
    chunks before the model (a fault read in the reference's place)."""
    dev = scan.device
    iso = float(traffic["iso_spacing"])
    chunk = tuple(int(c) for c in cfg["RESAMPLE_SIZE"])
    lo_w, hi_w = float(cfg["WINDOWING_MIN"]), float(cfg["WINDOWING_MAX"])
    n_lobes = 5
    with exact_f32():
        hu, lab = iso_resample(scan, lobe, spacing, iso,
                               float(traffic["pad_value"]))
        full = tuple(hu.shape)
        clo, chi = _box(lab > 0, 8, full)
        size = np.minimum(-(-(chi - clo) // 32) * 32, np.array(full))
        clo = np.maximum(np.minimum(clo, np.array(full) - size), 0)
        sl = tuple(slice(int(a), int(a + s)) for a, s in zip(clo, size))
        hu, lab = hu[sl], lab[sl]
        cand = candidate(hu, lab > 0, lo_w, hi_w)
        shape = tuple(int(s) for s in size)
        border = int(math.ceil(float(traffic["crop_border_mm"]) / iso))
        lows = np.zeros((n_lobes, 3), np.int64)
        sizes = np.ones((n_lobes, 3), np.int64)
        for li in range(n_lobes):
            a, b = _box(lab == li + 1, border, shape)
            lows[li], sizes[li] = a, b - a
        bucket = tuple(int(min(-(-int(sizes[:, ax].max()) // 16) * 16,
                               shape[ax])) for ax in range(3))
        starts = np.maximum(np.minimum(lows, np.array(shape)
                                       - np.array(bucket)), 0)
        offsets = lows - starts
        x80, l80, lmask, fws, bws = [], [], [], [], []
        win = torch.clamp((hu.float() - lo_w) / max(hi_w - lo_w, 1e-6),
                          0.0, 1.0)
        for li in range(n_lobes):
            bsl = tuple(slice(int(s), int(s) + b)
                        for s, b in zip(starts[li], bucket))
            m = lab[bsl] == li + 1
            lmask.append(m)
            fw, bw = [], []
            for ax in range(3):
                n = int(sizes[li, ax])
                src = np.arange(chunk[ax]) * n / chunk[ax]
                fw.append(tuple(torch.from_numpy(a).to(dev) for a in _tables(
                    src, n, int(offsets[li, ax]), bucket[ax])))
                p = np.arange(bucket[ax], dtype=np.float64) \
                    - int(offsets[li, ax])
                src = p * (chunk[ax] - 1) / max(n - 1, 1)
                bw.append(tuple(torch.from_numpy(a).to(dev) for a in _tables(
                    src, chunk[ax], 0, chunk[ax])))
            xw = torch.where(m, win[bsl], torch.zeros_like(win[bsl]))
            x = _resize(xw, fw)
            if li in drop_lobes:
                x = torch.zeros_like(x)
            x80.append(x)
            l80.append(_resize(m.float(), fw, nearest=True) > 0.5)
            bws.append(bw)
        x = torch.stack(x80)[:, None]
        l80 = torch.stack(l80).float()
        with torch.no_grad():
            _, refined = forward(x, P, cfg["MODEL"], False, QUANTS[quant])
        out = refined[:, 0]
        ratio = (torch.sigmoid(out) * l80).sum((1, 2, 3)) \
            / torch.clamp(l80.sum((1, 2, 3)), min=1.0)
        cam = torch.zeros(shape, device=dev)
        lung = torch.zeros(shape, dtype=torch.bool, device=dev)
        for li in range(n_lobes):
            c = torch.relu(_resize(out[li], bws[li]))
            box = torch.zeros(bucket, dtype=torch.bool, device=dev)
            box[tuple(slice(int(o), int(o) + int(s))
                      for o, s in zip(offsets[li], sizes[li]))] = True
            c = c / torch.clamp(c[box].max(), min=1e-12)
            c = c * (ratio[li] >= RATIO_GATE).float()
            bsl = tuple(slice(int(s), int(s) + b)
                        for s, b in zip(starts[li], bucket))
            cam[bsl] = torch.where(lmask[li], c, cam[bsl])
            lung[bsl] |= lmask[li]
        th = otsu_threshold(cam, lung)
        pred = torch.zeros(full, dtype=torch.bool, device=dev)
        pred[sl] = cam > th
        post = torch.zeros_like(pred)
        post[sl] = pred[sl] & cand
    return {"pred": pred, "post": post, "ratios": ratio.cpu().numpy(),
            "threshold": th}

"""Host-side pictures and logs: the confusion matrix of the ordinal
classes, the screenshot tiles and the scalar logger.

Port of dram_tpu/viz.py (`plot_confusion_matrix_from_data` :25,
`_zoom_and_pad`, `_pick_slices`, `_write_tile` :100-136,
`draw_mask_tile_single_view` :138, `draw_mask_tile_singleview_heatmap`
:180, `SummaryWriter` :223): the tiles pick `num_slices` evenly across
the object's extent, draw mask contours or blend JET heatmaps over each
slice, tile them horizontally, pad to 1920 px wide and write a jpg. cv2,
matplotlib, scipy and tensorboard are imported inside the functions:
without cv2 the tiles are skipped, without matplotlib the confusion
matrix raises ImportError (the runners log it as a warning), and without
tensorboard the SummaryWriter writes JSON lines.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np


def _cv2():
    """The cv2 module, or None where OpenCV is not installed."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def plot_confusion_matrix_from_data(y_true, y_pred, labels=None,
                                    save_path="cm", cmap="Oranges",
                                    figsize=(9, 9)):
    """Confusion-matrix heatmap with the reference's cell styling
    (reference job_runner.py:27-242, pred_val_axis='y' default): rows are
    predictions, columns actuals; interior cells show count + percent of
    the grand total with white-on-green diagonal cells and red off-diagonal
    text; totals row/column/corner cells get dark backgrounds with three
    stacked bold lines — count (white), correct% (green), error% (red).
    Saved as <save_path>.jpg."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = labels or sorted(set(list(y_true) + list(y_pred)))
    n = len(labels)
    idx = {l: i for i, l in enumerate(labels)}
    cm = np.zeros((n, n), np.int64)
    for t, p in zip(y_true, y_pred):
        # reference orientation: rows = predicted, cols = actual
        cm[idx[p], idx[t]] += 1

    ext = np.zeros((n + 1, n + 1), np.int64)
    ext[:n, :n] = cm
    ext[n, :n] = cm.sum(0)
    ext[:n, n] = cm.sum(1)
    ext[n, n] = cm.sum()
    total = max(int(cm.sum()), 1)

    fig, ax = plt.subplots(figsize=figsize)
    img = ax.imshow(ext, cmap=cmap)
    # cell background overrides (reference configcell_text_and_colors)
    diag_face = (0.35, 0.8, 0.55, 1.0)
    tot_face = (0.27, 0.30, 0.27, 1.0)
    corner_face = (0.17, 0.20, 0.17, 1.0)
    for i in range(n + 1):
        for j in range(n + 1):
            v = int(ext[i, j])
            is_tot = i == n or j == n
            if is_tot:
                face = corner_face if (i == n and j == n) else tot_face
                ax.add_patch(plt.Rectangle((j - 0.5, i - 0.5), 1, 1,
                                           facecolor=face, edgecolor="w",
                                           lw=0.5))
                if v:
                    k = min(i, j)
                    ok = (np.trace(cm) if i == j == n else int(cm[k, k]))
                    per_ok = 100.0 * ok / v
                else:
                    per_ok = 0.0
                for dy, txt, color in (
                        (-0.22, f"{v}", "w"),
                        (0.0, "100%" if per_ok == 100 else f"{per_ok:.2f}%",
                         "g"),
                        (0.22, f"{100 - per_ok:.2f}%", "r")):
                    ax.text(j, i + dy, txt, ha="center", va="center",
                            fontsize=8, fontweight="bold", color=color)
                continue
            if i == j:
                ax.add_patch(plt.Rectangle((j - 0.5, i - 0.5), 1, 1,
                                           facecolor=diag_face,
                                           edgecolor="w", lw=0.5))
            pct = 100.0 * v / total
            txt = f"{v}\n{pct:.2f}%" if v else "0"
            ax.text(j, i, txt, ha="center", va="center", fontsize=8,
                    color="w" if i == j else "r")
    tick = [str(l) for l in labels] + ["total"]
    ax.set_xticks(range(n + 1)), ax.set_xticklabels(tick, rotation=45)
    ax.set_yticks(range(n + 1)), ax.set_yticklabels(tick, rotation=25)
    ax.set_xlabel("Actual"), ax.set_ylabel("Predicted")
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    fig.savefig(str(save_path) + ".jpg", bbox_inches="tight", dpi=100)
    plt.close(fig)


def _zoom_and_pad(vol, zoom_size, coord_axis, order):
    from scipy import ndimage
    sp = [vol.shape[s] for s in range(vol.ndim) if s != coord_axis]
    ratio = zoom_size / max(sp)
    zooms = [1.0 if n == coord_axis else ratio for n in range(vol.ndim)]
    z = ndimage.zoom(vol, zooms, order=order)
    crop = tuple(slice(0, min(n, zoom_size)) if i != coord_axis
                 else slice(None) for i, n in enumerate(z.shape))
    z = z[crop]
    pad = tuple((0, 0) if n == coord_axis else
                ((zoom_size - zs) // 2, zoom_size - zs - (zoom_size - zs) // 2)
                for n, zs in zip(range(vol.ndim), z.shape))
    return np.pad(z, pad, mode="constant")


def _pick_slices(coord_mask, num_slices, coord_axis):
    proj = np.where(coord_mask.any(axis=tuple(
        i for i in range(coord_mask.ndim) if i != coord_axis)))[0]
    if len(proj) == 0:
        return None
    s, e = int(proj[0]), int(proj[-1]) + 1
    stride = (e - s) // num_slices
    if stride == 0:
        s, e = 0, coord_mask.shape[coord_axis] - 1
        stride = max(1, (e - s) // num_slices)
    return list(range(s, e, stride))[:num_slices]


def _write_tile(tiles, output_path, ext):
    draw = np.hstack(tiles)
    padw = max(0, 1920 - draw.shape[1])
    draw = np.pad(draw, ((0, 0), (padw // 2, padw - padw // 2), (0, 0)),
                  mode="constant")
    out = Path(output_path).absolute()
    os.makedirs(out.parent, exist_ok=True)
    _cv2().imwrite(str(out) + f".{ext}", draw)


def draw_mask_tile_single_view(image, masks_list, coord_mask, num_slices,
                               output_path, colors, thickness, ext="jpg",
                               alpha=0.5, flip_axis=0, zoom_size=360,
                               coord_axis=1, titles=None):
    """Contour-overlay tiling (reference utils.py:464-539); does nothing
    without cv2."""
    cv2 = _cv2()
    if cv2 is None:
        return
    image = np.asarray(image, np.float32)
    if flip_axis is not None:
        image = np.flip(image, flip_axis)
        coord_mask = np.flip(coord_mask, flip_axis)
        masks_list = [[np.flip(m, flip_axis) for m in ml] for ml in masks_list]
    image = _zoom_and_pad(image, zoom_size, coord_axis, 1)
    coord_mask = _zoom_and_pad(coord_mask.astype(np.uint8), zoom_size,
                               coord_axis, 0)
    masks_list = [[_zoom_and_pad(m.astype(np.uint8), zoom_size, coord_axis, 0)
                   for m in ml] for ml in masks_list]
    slice_ids = _pick_slices(coord_mask > 0, num_slices, coord_axis)
    if slice_ids is None:
        return
    tiles = []
    for sid in slice_ids:
        sl = np.take(image, sid, axis=coord_axis).astype(np.uint8)
        rows = [np.dstack([sl] * 3)]
        for gi, ml in enumerate(masks_list):
            blend = np.dstack([sl] * 3).copy()
            for m, color, thick in zip(ml, colors, thickness):
                msl = np.take(m, sid, axis=coord_axis).astype(np.uint8)
                cnts, _ = cv2.findContours(msl, cv2.RETR_TREE,
                                           cv2.CHAIN_APPROX_SIMPLE)
                cv2.drawContours(blend, cnts, -1, color, thick)
            rendered = (np.dstack([sl] * 3) * (1 - alpha) + blend * alpha) \
                .astype(np.uint8)
            if titles:
                cv2.putText(rendered, titles[gi], (10, 10),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1,
                            cv2.LINE_AA)
            rows.append(rendered)
        tiles.append(np.vstack(rows))
    _write_tile(tiles, output_path, ext)


def draw_mask_tile_singleview_heatmap(image, masks_list, coord_mask,
                                      num_slices, output_path, ext="jpg",
                                      alpha=0.5, flip_axis=0, zoom_size=360,
                                      colormap="jet", coord_axis=1,
                                      titles=None):
    """JET-colormap heatmap tiling (reference utils.py:542-620); does
    nothing without cv2."""
    cv2 = _cv2()
    if cv2 is None:
        return
    image = np.asarray(image, np.float32)
    if flip_axis is not None:
        image = np.flip(image, flip_axis)
        coord_mask = np.flip(coord_mask, flip_axis)
        masks_list = [[np.flip(m, flip_axis) for m in ml] for ml in masks_list]
    image = _zoom_and_pad(image, zoom_size, coord_axis, 1)
    coord_mask = _zoom_and_pad(coord_mask.astype(np.uint8), zoom_size,
                               coord_axis, 0)
    masks_list = [[_zoom_and_pad(np.asarray(m, np.float32), zoom_size,
                                 coord_axis, 0) for m in ml]
                  for ml in masks_list]
    slice_ids = _pick_slices(coord_mask > 0, num_slices, coord_axis)
    if slice_ids is None:
        return
    cmap = {"jet": cv2.COLORMAP_JET, "summer": cv2.COLORMAP_SUMMER}[colormap]
    tiles = []
    for sid in slice_ids:
        sl = np.take(image, sid, axis=coord_axis).astype(np.uint8)
        rows = [np.dstack([sl] * 3)]
        for gi, ml in enumerate(masks_list):
            blend = np.dstack([sl] * 3)
            for m in ml:
                msl = np.take(m, sid, axis=coord_axis).astype(np.uint8)
                heat = cv2.applyColorMap(msl, cmap)
                blend = cv2.addWeighted(heat, alpha, blend, 1 - alpha, 0.0)
            if titles:
                blend = blend.copy()
                cv2.putText(blend, titles[gi], (50, 50),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1,
                            cv2.LINE_AA)
            rows.append(blend)
        tiles.append(np.vstack(rows))
    _write_tile(tiles, output_path, ext)


class SummaryWriter:
    """Scalar and histogram logger under `log_dir`: tensorboard's
    SummaryWriter where torch.utils.tensorboard imports, else JSON lines
    in scalars.jsonl ({"tag", "step", name: value, ...}) and
    histograms.jsonl ({"tag", "step", "count", "quantiles": the 11
    deciles})."""

    def __init__(self, log_dir):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        self._fp = self._hfp = None
        try:
            from torch.utils.tensorboard import SummaryWriter as TB
            self._tb = TB(log_dir=log_dir)
        except Exception:
            pass

    def _jsonl(self, fp, name, row):
        if fp is None:
            fp = open(os.path.join(self.log_dir, name), "at")
        fp.write(json.dumps(row) + "\n")
        fp.flush()
        return fp

    def add_scalars(self, tag, scalars, global_step):
        if self._tb is not None:
            self._tb.add_scalars(tag, scalars, global_step)
            return
        self._fp = self._jsonl(self._fp, "scalars.jsonl", {
            "tag": tag, "step": global_step,
            **{k: float(v) for k, v in scalars.items()}})

    def add_scalar(self, tag, value, global_step):
        self.add_scalars(tag, {tag: value}, global_step)

    def add_histogram(self, tag, values, global_step):
        values = np.asarray(values)
        if self._tb is not None:
            self._tb.add_histogram(tag, values, global_step)
            return
        q = np.quantile(values.astype(np.float64).reshape(-1),
                        np.linspace(0.0, 1.0, 11))
        self._hfp = self._jsonl(self._hfp, "histograms.jsonl", {
            "tag": tag, "step": global_step, "count": int(values.size),
            "quantiles": [float(v) for v in q]})

    def close(self):
        if self._tb is not None:
            self._tb.close()
        for fp in (self._fp, self._hfp):
            if fp is not None:
                fp.close()
        self._fp = self._hfp = None

"""Host-side pictures of the inference engine: the confusion matrix of
the per-lobe classes and the heatmap screenshot tiles.

Port of dram_tpu/viz.py (`plot_confusion_matrix_from_data` :25,
`_zoom_and_pad`, `_pick_slices`, `_write_tile` :100-136,
`draw_mask_tile_singleview_heatmap` :180): pick `num_slices` evenly
across the object's extent, blend JET heatmaps over each slice, tile them
horizontally, pad to 1920 px wide and write a jpg. cv2, matplotlib and
scipy are imported inside the functions: without cv2 the tiles are
skipped, and without matplotlib the confusion matrix raises ImportError
(the engine logs it as a warning).
"""

from __future__ import annotations

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

"""A reference answer on the scan's own grid, and the lobe labels of its
ratios.

`on_scan_grid`: a mask of the full iso grid resampled to the scan grid
by nearest neighbour: scan voxel j of an axis (spacing s) lies at iso
coordinate j * s / iso of the grid that shares its origin, and takes
iso voxel floor(j * s / iso + 0.5); a voxel whose nearest iso voxel lies
past the iso grid is False. `labels`: each lobe's CTSS class, the index
of the interval [CTSS_RATIO_LB, CTSS_RATIO_UB) that holds its predicted
lesion ratio (5 above them all)."""

import numpy as np
import torch

from .train import CTSS_RATIO_LB, CTSS_RATIO_UB


def on_scan_grid(mask, out_shape, spacing, iso):
    """(D, H, W) bool of the scan grid from a device mask of the iso
    grid."""
    out = mask
    for ax in range(3):
        n = int(mask.shape[ax])
        idx = np.floor(np.arange(int(out_shape[ax]), dtype=np.float64)
                       * (float(spacing[ax]) / float(iso)) + 0.5) \
            .astype(np.int64)
        inside = torch.from_numpy(idx < n).to(mask.device)
        out = torch.index_select(
            out, ax, torch.from_numpy(np.minimum(idx, n - 1)).to(mask.device))
        shape = [1, 1, 1]
        shape[ax] = -1
        out = out & inside.reshape(shape)
    return out


def labels(ratios):
    """[class] of each ratio."""
    out = []
    for r in np.asarray(ratios, np.float64).ravel():
        k = [i for i, (lo, hi) in enumerate(zip(CTSS_RATIO_LB, CTSS_RATIO_UB))
             if lo <= r < hi]
        out.append(k[0] if k else 5)
    return out

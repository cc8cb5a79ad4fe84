"""DRAM interval-regression loss, the weak-supervision objective.

Port of dram_tpu/losses/interval_reg.py (`get_labels` :32,
`ratio_to_label` :54, `compute_enc_loss` :75,
`compute_reg_loss_with_probs` :91, `IntRegLoss` :124). The CTSS score
implies an interval of admissible lesion-volume ratios per lobe; the
predicted ratio (lobe-masked mean of the sigmoid CAM) is penalised with a
squared hinge for leaving the intersection of that interval with a band
around the intensity-derived pseudo-ratio. Branchless and fixed-shape as
in the JAX package. Under data parallelism (`group`, dram_tpu's
`axis_name`) the batch sums run over the ranks (core/ops.gsum).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.ops import CTSS_RATIO_LB, CTSS_RATIO_UB, gsum, masked_mean

__all__ = ["CTSS_RATIO_LB", "CTSS_RATIO_UB", "DEFAULT_CTSS_FREQUENCY",
           "get_labels", "ratio_to_label", "compute_enc_loss",
           "compute_reg_loss_with_probs", "IntRegLoss"]

# static fallback frequency map (interval_reg.py:27-29); the trainer
# normally passes the sampler-derived map instead
DEFAULT_CTSS_FREQUENCY = np.array([0.3, 0.25, 0.23, 0.2, 0.18, 0.15],
                                  np.float32)


def _table(a, like):
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def get_labels(ctsses, lesion_ps, band_width):
    """(B,) int scores + (B,) pseudo-ratio upper bounds -> (B, 2)
    intervals: [ctss_lb, ctss_ub] intersected with [p - bw, p + bw]; when
    empty, the band (if it lies below the interval) or the interval (if
    the band lies above)."""
    idx = ctsses.long()
    lb = torch.clamp(lesion_ps - band_width, min=0.0)
    ub = torch.clamp(lesion_ps + band_width, max=1.0)
    ctss_lb = _table(CTSS_RATIO_LB, lesion_ps)[idx]
    ctss_ub = _table(CTSS_RATIO_UB, lesion_ps)[idx]
    lo = torch.maximum(ctss_lb, lb)
    hi = torch.minimum(ctss_ub, ub)
    empty = hi < lo
    below = ub <= ctss_lb  # band entirely below the score interval
    lo = torch.where(empty, torch.where(below, lb, ctss_lb), lo)
    hi = torch.where(empty, torch.where(below, ub, ctss_ub), hi)
    return torch.stack([lo, hi], dim=-1)


def ratio_to_label(ratios):
    """Host-side inverse lookup: predicted ratio -> ordinal class."""
    ratios = np.atleast_1d(np.asarray(ratios, np.float64))
    labels = []
    for r in ratios:
        idx = np.where((CTSS_RATIO_LB <= r) & (r < CTSS_RATIO_UB))[0]
        labels.append(int(idx[0]) if len(idx) else 5)
    return labels


def compute_enc_loss(p, sample_weight=None, group=None):
    """Entropy regulariser pushing probabilities toward {0, 1}; with
    `sample_weight` (B,), rows of weight 0 are excluded exactly; with a
    `group` the mean pools over the global batch."""
    ent = (-p * torch.log(p + 1e-7)) + (p - 1.0) * torch.log(1.0 - p + 1e-7)
    if sample_weight is None:
        n = torch.tensor(float(ent.numel()), dtype=ent.dtype,
                         device=ent.device)
        return gsum(ent, group) / gsum(n, group)
    w = sample_weight.to(ent.dtype)
    per_sample = ent.mean(tuple(range(1, ent.dim())))
    return gsum(per_sample * w, group) / \
        torch.clamp(gsum(w, group), min=1e-12)


def compute_reg_loss_with_probs(probs, lobes, lesion_candidates, ctsses,
                                band_width, ctss_frequency=None,
                                sample_weight=None, group=None):
    """probs/lobes/lesion_candidates: (B, D, H, W, 1); ctsses: (B,) ints.
    The summed squared-hinge interval loss, weighted by the inverse
    clamped label frequency; `sample_weight` (B,) zeroes rows exactly;
    with a `group` the sum runs over the global batch."""
    if ctss_frequency is None:
        ctss_frequency = DEFAULT_CTSS_FREQUENCY
    freq = torch.as_tensor(ctss_frequency, dtype=torch.float32,
                           device=probs.device)
    dims = tuple(range(1, probs.dim()))
    lobes_f = (lobes > 0).to(probs.dtype)
    cand_f = (lesion_candidates > 0).to(probs.dtype)
    ratio_upper_bound = (cand_f * lobes_f).sum(dims) / \
        torch.clamp(lobes_f.sum(dims), min=1e-12)
    pred_ratio = masked_mean(probs, lobes_f, dims)

    targets = get_labels(ctsses, ratio_upper_bound, band_width)
    lo, hi = targets[:, 0], targets[:, 1]
    k = (0.5 * (hi - lo)) ** 2
    loss_unhinge = (pred_ratio - (hi + lo) / 2.0) ** 2 - k
    loss_unweight = torch.clamp(loss_unhinge, min=0.0)

    wf = torch.clamp(freq[ctsses.long()], 0.2, 0.8)
    per_sample = loss_unweight / wf
    if sample_weight is not None:
        per_sample = per_sample * sample_weight.to(per_sample.dtype)
    return gsum(per_sample, group)


class IntRegLoss:
    """Returns (reg_loss, entropy_loss). `model_fn(images, lobes) ->
    (dense_outs, refined_dense_outs)`: the loss calls the model itself,
    as the reference's training contract does."""

    n_losses = 2

    def __init__(self, band_width=5e-2, **kwargs):
        self.band_width = band_width

    def ratio_to_label(self, ratios):
        return ratio_to_label(ratios)

    def __call__(self, model_fn, images, lobes, lesions, ctsses,
                 ctss_frequency=None, rng=None, sample_weight=None,
                 group=None, **kwargs):
        dense_outs, _ = model_fn(images, lobes)
        probs = torch.sigmoid(dense_outs)
        reg_loss = compute_reg_loss_with_probs(
            probs, lobes, lesions, ctsses, self.band_width, ctss_frequency,
            sample_weight, group)
        enc_loss = compute_enc_loss(probs, sample_weight, group)
        return reg_loss, enc_loss

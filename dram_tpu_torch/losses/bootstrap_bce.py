"""Bootstrapped and class-balanced binary cross-entropies.

Port of dram_tpu/losses/bootstrap_bce.py (`BootBinCrossEntropy` :23-70,
`BinaryCrossEntropySmooth` :73). Every region statistic is a masked
reduction with fixed shapes, pooled over the whole batch as the
reference's flattened boolean indexing pools it, over the ranks of
`group` under data parallelism (dram_tpu's `axis_name`).
"""

from __future__ import annotations

import torch

from ..core.ops import gsum


def _masked_mean(x, m, group=None):
    m = m.to(x.dtype)
    return gsum(x * m, group) / torch.clamp(gsum(m, group), min=1e-12)


class BootBinCrossEntropy:
    """Outside-lobe plain BCE toward 0 + inside-lobe class-balanced BCE
    blended with a self-bootstrap term. p: probabilities, t: {0, 1}
    pseudo targets, voi: region of interest; all shapes equal."""

    def __init__(self, smoothing=0.1):
        self.smoothing = smoothing
        self.eps = 1e-7

    def __call__(self, p, t, voi, class_weights=None, sample_weight=None,
                 group=None):
        t = t.to(p.dtype)
        outside = (voi < 1e-7).to(p.dtype)
        inside = (voi > 0.0).to(p.dtype)
        if sample_weight is not None:
            # rows of weight 0 leave every pooled statistic as without them
            w_b = sample_weight.to(p.dtype).reshape(
                (-1,) + (1,) * (p.dim() - 1))
            outside = outside * w_b
            inside = inside * w_b

        pt = p * t + (1.0 - p) * (1.0 - t)
        nll = -torch.log(torch.clamp(pt, self.eps, 1.0 - self.eps))
        bceo_loss = _masked_mean(nll, outside, group)

        # alpha balances over the whole batch
        n_in = gsum(inside, group)
        t_in = gsum(t * inside, group)
        alpha = torch.clamp(1.0 - t_in / torch.clamp(n_in, min=1e-12),
                            0.25, 0.75)
        w = (alpha * t + (1.0 - alpha) * (1.0 - t)) * inside
        bce_loss = gsum(nll * w, group) / torch.clamp(gsum(w, group),
                                                      min=1e-12)

        t_hat = (p > 0.5).to(p.dtype)
        pt_hat = p * t_hat + (1.0 - p) * (1.0 - t_hat)
        nll_hat = -torch.log(torch.clamp(pt_hat, self.eps, 1.0 - self.eps))
        bootstrap_loss = _masked_mean(nll_hat, inside, group)

        inside_term = (1.0 - self.smoothing) * bce_loss + \
            self.smoothing * bootstrap_loss
        return bceo_loss + torch.where(n_in > 0, inside_term,
                                       torch.zeros_like(inside_term))


class BinaryCrossEntropySmooth:
    """Class-balanced weighted BCE over the flattened batch (unused by the
    shipped configs)."""

    def __init__(self, smooth):
        self.smooth = smooth
        self.eps = 1e-6

    def __call__(self, probs, targets):
        p = probs.reshape(-1)
        t = targets.reshape(-1).to(p.dtype)
        alpha = torch.clamp(1.0 - t.sum() / t.shape[0], 0.3, 0.7)
        p = torch.clamp(p, self.eps, 1.0 - self.eps)
        pt = torch.log(p) * t + torch.log(1.0 - p) * (1.0 - t)
        w = alpha * t + (1.0 - alpha) * (1.0 - t)
        nll = -self.smooth * pt * w
        return nll.sum() / w.sum()

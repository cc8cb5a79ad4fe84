"""IntRegRefineLoss, the configured training loss of st_dram_ref.

Port of dram_tpu/losses/refine.py (`pseudo_labels` :23,
`IntRegRefineLoss` :40): (1) the interval-regression loss on the first
head's probabilities; (2) a bootstrapped segmentation loss training the
refined head against pseudo-labels thresholded from the first head, on
the device and outside the gradient. DC3D returns (dense, dense), so its
refined head is the dense head itself, as in the JAX package.
"""

from __future__ import annotations

import torch

from .bootstrap_bce import BootBinCrossEntropy
from .interval_reg import IntRegLoss, compute_reg_loss_with_probs


@torch.no_grad()
def pseudo_labels(dense_outs, lobes, lesion_candidates, ctsses):
    """(sigmoid(dense) > 0.5) & inside-lobe & intensity-candidate, zeroed
    where the lobe's CTSS is 0; f32, no gradient."""
    probs = torch.sigmoid(dense_outs)
    pred = (probs > 0.5) & (lobes > 0)
    cand = pred & (lesion_candidates > 0)
    score_pos = ctsses.float() >= 1e-7
    shape = [-1] + [1] * (dense_outs.dim() - 1)
    return (cand & score_pos.reshape(shape)).float()


class IntRegRefineLoss(IntRegLoss):
    n_losses = 2

    def __init__(self, band_width=1e-2, smoothing=0.1, refine_method="th",
                 config_param=None, **kwargs):
        super().__init__(band_width)
        if refine_method != "th":
            raise NotImplementedError(f"refine method {refine_method}")
        self.smoothing = smoothing
        self.bootstrap_loss = BootBinCrossEntropy(smoothing)

    def compute_seg_loss(self, dense_outs, refined_dense_outs, lobes,
                         lesions, ctsses, sample_weight=None, group=None):
        pseudo = pseudo_labels(dense_outs, lobes, lesions, ctsses)
        p = torch.sigmoid(refined_dense_outs)
        voi = (lobes > 0).to(p.dtype)
        return self.bootstrap_loss(p, pseudo, voi,
                                   sample_weight=sample_weight, group=group)

    def __call__(self, model_fn, images, lobes, lesions, ctsses,
                 ctss_frequency=None, rng=None, sample_weight=None,
                 group=None, **kwargs):
        dense_outs, refined_dense_outs = model_fn(images, lobes)
        probs = torch.sigmoid(dense_outs)
        reg_loss = compute_reg_loss_with_probs(
            probs, lobes, lesions, ctsses, self.band_width, ctss_frequency,
            sample_weight, group)
        seg_loss = self.compute_seg_loss(dense_outs, refined_dense_outs,
                                         lobes, lesions, ctsses,
                                         sample_weight, group)
        return reg_loss, seg_loss

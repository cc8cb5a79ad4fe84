"""Equivariance (affine-consistency) losses with one-shot transforms.

Port of dram_tpu/losses/equivariance.py (the reference IntRegAffLoss /
IntRegAffRefineLoss, reference metrics.py:213-308, 376-462): the model
runs on a batch and on its transform T(batch); the losses hold T(probs)
against the transformed run's probs (smooth L1 inside the transformed
lobes) besides the interval regression of both runs. T is a composition
rescale? -> (flip?, rot90?) in a random order, each kept with p = 0.6:
the rescale's target size is drawn on the host per step from the
configured pool (draw_rescale_static, numpy, the same size as dram_tpu's
for a seed; the epoch loop reseeds it), flips and quarter turns per call.

dram_tpu draws T's decisions from jax.random; here they come from an
explicit torch.Generator (`rng`), so the distributions are equal and the
draws differ. `OneShotTransform(decisions=...)` takes given decisions
instead (the tests hand it dram_tpu's).
"""

from __future__ import annotations

from itertools import combinations, permutations

import numpy as np
import torch

from ..core.ops import gsum
from ..core.resample import resize3d
from .interval_reg import IntRegLoss, compute_enc_loss, \
    compute_reg_loss_with_probs
from .refine import IntRegRefineLoss

# NDHWC spatial axes
FLIP_VARIANTS = [c for n in (1, 2, 3) for c in combinations((1, 2, 3), n)]
ROT_VARIANTS = [(k, ax) for ax in permutations((1, 2, 3), 2)
                for k in (1, 2, 3)]


def flip3d_oneshot(x, variant):
    """Flip over a subset of the spatial axes (ref Flip3DOneShot)."""
    return torch.flip(x, dims=FLIP_VARIANTS[variant])


def rot903d_oneshot(x, variant):
    """Quarter-turn rotation (ref Rotate903DOneShot): torch.rot90 turns
    from the first axis towards the second, as jnp.rot90 does."""
    k, ax = ROT_VARIANTS[variant]
    return torch.rot90(x, k=k, dims=ax)


def rescale3d_oneshot(x, size, is_reference):
    """Fixed-target-size rescale (ref Rescale3DOneShot, mode='size'):
    half-pixel trilinear (torch's default align_corners=False) for
    images, nearest for references."""
    method = "nearest" if is_reference else "trilinear"
    return resize3d(x, size, method=method, align_corners=False)


def _linear_taps(coord, n):
    """(index, weight, valid) of the two order-1 taps of each coordinate
    along an axis of n samples (jax.scipy.ndimage.map_coordinates,
    mode 'constant': a tap outside [0, n) contributes 0)."""
    lo = torch.floor(coord)
    w_hi = coord - lo
    lo = lo.long()
    return [(i, w, (i >= 0) & (i < n)) for i, w in
            ((lo, 1.0 - w_hi), (lo + 1, w_hi))]


def rotate3d_x_oneshot(x, theta):
    """Rotation of (B, D, H, W, C) about the x (last spatial) axis by
    `theta` radians (ref Rotate3DXOneShot): order-1 resampling at the
    rotated coordinates with zeros outside, in f32 (dram_tpu's
    map_coordinates(order=1, mode='constant'))."""
    B, D, H, W, C = x.shape
    dev = x.device
    f32 = torch.float32
    dz = torch.arange(D, dtype=f32, device=dev) - (D - 1) / 2.0
    dy = torch.arange(H, dtype=f32, device=dev) - (H - 1) / 2.0
    dx = torch.arange(W, dtype=f32, device=dev) - (W - 1) / 2.0
    gz, gy, gx = torch.meshgrid(dz, dy, dx, indexing="ij")
    theta = torch.as_tensor(theta, dtype=f32, device=dev)
    c, s = torch.cos(theta), torch.sin(theta)
    src = (c * gz - s * gy + (D - 1) / 2.0, s * gz + c * gy + (H - 1) / 2.0,
           gx + (W - 1) / 2.0)
    taps = [_linear_taps(q, n) for q, n in zip(src, (D, H, W))]
    vol = x.float().reshape(B, D * H * W, C)
    out = torch.zeros(B, D, H, W, C, dtype=f32, device=dev)
    for iz, wz, vz in taps[0]:
        for iy, wy, vy in taps[1]:
            for ix, wx, vx in taps[2]:
                valid = vz & vy & vx
                flat = ((iz.clamp(0, D - 1) * H + iy.clamp(0, H - 1)) * W
                        + ix.clamp(0, W - 1)).reshape(-1)
                vals = vol[:, flat].reshape(B, D, H, W, C)
                w = (wz * wy * wx * valid)[None, ..., None]
                out = out + w * vals
    return out.to(x.dtype)


def shape_preserving_rot_variants(spatial):
    """Indices into ROT_VARIANTS that keep (D, H, W) = `spatial`: k = 2
    always, k = 1 / 3 only over axes of equal extent
    (dram_tpu's _shape_preserving_rot_variants)."""
    return [i for i, (k, ax) in enumerate(ROT_VARIANTS)
            if k == 2 or spatial[ax[0] - 1] == spatial[ax[1] - 1]]


def draw_rescale_static(seed, pool):
    """The host's draw of the rescale op for a seed: kept with p = 0.6
    (integers(0, 10) < 6) and then a per-axis size drawn from `pool`;
    a (D, H, W) tuple or None. numpy's default_rng, as dram_tpu draws
    it, so both packages draw the same size for a seed."""
    if not pool:
        return None
    rng = np.random.default_rng(seed)
    if rng.integers(0, 10) >= 6:
        return None
    return tuple(int(s) for s in rng.choice(np.asarray(pool, np.int64), 3))


class OneShotTransform:
    """rescale? -> (flip?, rot90?) in a random order: the same T for
    every (B, D, H, W, C) tensor it is called on, so images, probs and
    lobes go through one transform. Decisions: keep (flip, rot) each
    with p = keep_prob, the flip variant (uniform over 7), the order
    (flip first with p = 0.5) and the quarter turn (uniform over the
    shape-preserving variants of the rescaled grid), drawn from the
    torch.Generator `generator`, or given as `decisions` = {"keep":
    (bool, bool), "flip_variant": int, "flip_first": bool, "rot_index":
    index into the shape-preserving variants}."""

    def __init__(self, generator=None, rescale_size=None, keep_prob=0.6,
                 decisions=None):
        self.rescale_size = rescale_size
        if decisions is not None:
            self.keep = tuple(bool(k) for k in decisions["keep"])
            self.flip_variant = int(decisions["flip_variant"])
            self.flip_first = bool(decisions["flip_first"])
            self._rot_index = int(decisions["rot_index"])
            self._rot_u = None
            return
        g = generator
        self.keep = tuple(bool(k) for k in
                          (torch.rand(2, generator=g) < keep_prob).tolist())
        self.flip_variant = int(torch.randint(0, len(FLIP_VARIANTS), (),
                                              generator=g))
        self._rot_u = float(torch.rand((), generator=g))
        self.flip_first = bool(torch.rand((), generator=g) < 0.5)
        self._rot_index = None

    def rot_variant(self, spatial):
        allowed = shape_preserving_rot_variants(spatial)
        i = self._rot_index if self._rot_u is None \
            else min(int(self._rot_u * len(allowed)), len(allowed) - 1)
        return allowed[i]

    def __call__(self, x, is_reference=False):
        if self.rescale_size is not None:
            x = rescale3d_oneshot(x, self.rescale_size, is_reference)
        rot = self.rot_variant(tuple(x.shape[1:4]))

        def do_flip(v):
            return flip3d_oneshot(v, self.flip_variant) if self.keep[0] \
                else v

        def do_rot(v):
            return rot903d_oneshot(v, rot) if self.keep[1] else v
        # rot90 gives a strided view: the kernels take contiguous tensors
        out = do_rot(do_flip(x)) if self.flip_first else do_flip(do_rot(x))
        return out.contiguous()

    def __repr__(self):
        return (f"keep={list(self.keep)}, flip_variant={self.flip_variant}, "
                f"flip_first={self.flip_first}, "
                f"rescale_size={self.rescale_size}")


def smooth_l1_masked(a, b, mask, beta=1.0, sample_weight=None,
                     group=None):
    """torch F.smooth_l1_loss over the masked elements (mean); rows of
    `sample_weight` 0 drop out; with a `group` the mean pools over the
    global batch."""
    d = (a - b).abs()
    loss = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    m = mask.to(loss.dtype)
    if sample_weight is not None:
        m = m * sample_weight.to(m.dtype).reshape(
            (-1,) + (1,) * (m.dim() - 1))
    return gsum(loss * m, group) / torch.clamp(gsum(m, group), min=1e-12)


class IntRegAffLoss(IntRegLoss):
    """((reg + aff_reg) / 2, consistency smooth L1, entropy): 3 losses
    (reference metrics.py:213-308)."""

    n_losses = 3

    def __init__(self, rescale_jitter=None, band_width=5e-2, **kwargs):
        super().__init__(band_width)
        self.rescale_jitter = rescale_jitter
        self.epoch_reseed(0)

    def epoch_reseed(self, seed):
        """Redraw the rescale's size; True when it changed."""
        size = draw_rescale_static(seed, self.rescale_jitter)
        changed = size != getattr(self, "_static_rescale_size", None)
        self._static_rescale_size = size
        return changed

    def static_key(self):
        return ("rescale", self._static_rescale_size)

    def _transform(self, rng, spatial):
        return OneShotTransform(rng, rescale_size=self._static_rescale_size)

    def _draw(self, rng, images):
        if rng is None:
            rng = torch.Generator().manual_seed(0)
        return self._transform(rng, images.shape[1:4])

    def __call__(self, model_fn, images, lobes, lesions, ctsses,
                 ctss_frequency=None, rng=None, sample_weight=None,
                 transform=None, group=None, **kwargs):
        """`rng`: the torch.Generator T is drawn from (seed 0 when None);
        `transform`: a given T instead."""
        T = transform or self._draw(rng, images)
        aff_images = T(images)
        aff_lobes = T(lobes, is_reference=True)
        aff_lesions = T(lesions, is_reference=True)

        dense_outs, _ = model_fn(images, lobes)
        probs = torch.sigmoid(dense_outs)
        reg_loss = compute_reg_loss_with_probs(
            probs, lobes, lesions, ctsses, self.band_width, ctss_frequency,
            sample_weight, group)
        enc_loss = compute_enc_loss(probs, sample_weight, group)

        aff_dense, _ = model_fn(aff_images, aff_lobes)
        aff_probs = torch.sigmoid(aff_dense)
        aff_reg_loss = compute_reg_loss_with_probs(
            aff_probs, aff_lobes, aff_lesions, ctsses, self.band_width,
            ctss_frequency, sample_weight, group)

        aff_loss = smooth_l1_masked(T(probs), aff_probs, aff_lobes > 0,
                                    sample_weight=sample_weight,
                                    group=group)
        return (reg_loss + aff_reg_loss) / 2.0, aff_loss, enc_loss


class IntRegAffRefineLoss(IntRegAffLoss):
    """((reg + aff_reg) / 2, (aff + aff_cls) / 2, (seg + aff_seg) / 2)
    (reference metrics.py:376-462)."""

    n_losses = 3

    def __init__(self, rescale_jitter=None, band_width=5e-2, smoothing=0.05,
                 refine_method="th", config_param=None, **kwargs):
        super().__init__(rescale_jitter, band_width)
        self.seg_loss = IntRegRefineLoss(band_width, smoothing,
                                         refine_method=refine_method)

    def __call__(self, model_fn, images, lobes, lesions, ctsses,
                 ctss_frequency=None, rng=None, sample_weight=None,
                 transform=None, group=None, **kwargs):
        T = transform or self._draw(rng, images)
        aff_images = T(images)
        aff_lobes = T(lobes, is_reference=True)
        aff_lesions = T(lesions, is_reference=True)

        dense_outs, refined_dense_outs = model_fn(images, lobes)
        probs = torch.sigmoid(dense_outs)
        reg_loss = compute_reg_loss_with_probs(
            probs, lobes, lesions, ctsses, self.band_width, ctss_frequency,
            sample_weight, group)

        aff_dense, aff_refined = model_fn(aff_images, aff_lobes)
        aff_probs = torch.sigmoid(aff_dense)
        aff_reg_loss = compute_reg_loss_with_probs(
            aff_probs, aff_lobes, aff_lesions, ctsses, self.band_width,
            ctss_frequency, sample_weight, group)

        inside = aff_lobes > 0
        aff_loss = smooth_l1_masked(T(probs), aff_probs, inside,
                                    sample_weight=sample_weight,
                                    group=group)
        aff_loss_cls = smooth_l1_masked(T(refined_dense_outs), aff_refined,
                                        inside, sample_weight=sample_weight,
                                        group=group)
        seg_loss = self.seg_loss.compute_seg_loss(
            dense_outs, refined_dense_outs, lobes, lesions, ctsses,
            sample_weight, group)
        seg_aff_loss = self.seg_loss.compute_seg_loss(
            aff_dense, aff_refined, aff_lobes, aff_lesions, ctsses,
            sample_weight, group)
        return ((reg_loss + aff_reg_loss) / 2.0,
                (aff_loss + aff_loss_cls) / 2.0,
                (seg_loss + seg_aff_loss) / 2.0)

"""One training step of the port and an entry point that drives a few.

Port of the single-device core of dram_tpu/train/trainer.py: the wire
(`unpack_image_wire` :88, `pack_train_batch` :107, `MaskWireLatch` :61),
the optimizer and scheduler registry targets (`adam` :164,
`ExponentialLR` :177 with its state :192-200), `fix_random_seeds` (:206)
and the body of `_build_train_step` / `train_step` (:483-578) as
`TrainStep`: the loss drives the model through a `model_fn` closure, the
objective is sum(factor * loss) with the arity check of :533-542, then
the backward through the port's kernels, the Adam step and the BatchNorm
running-stat update (done by the model's train-mode forward).
`train_steps` builds model, initializer or weights, optimizer and loss
from a settings module (dram_tpu_torch/configs) and runs a few steps; the
epoch loop is train/chunk_train.py. Not ported: the multi-device mesh
(ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from .. import require_cuda, weights
from ..configs import get_callable_by_name
from ..losses.interval_reg import DEFAULT_CTSS_FREQUENCY
from ..models.dc3d_at import DC3DATGeneric
from ..models.unet3d import DC3D


class MaskWireLatch:
    """One-way u8 -> f32 latch for the mask wire dtype: the masks ship as
    u8 until the first batch that is not exactly representable, then as
    f32 for the rest of the run."""

    def __init__(self):
        self.u8_ok = True

    def pack(self, m):
        if self.u8_ok:
            q = m.astype(np.uint8)
            if (q == m).all():
                return q
            self.u8_ok = False
            logging.getLogger(__name__).warning(
                "mask wire: batch not u8-representable; latching the mask "
                "wire to f32 for this run")
        return m


def unpack_image_wire(images, span):
    """Inverse of the u16 image wire: `span` (B, 2) holds each row's own
    (lo, hi); other dtypes are cast to f32 unchanged."""
    if images.dtype == torch.uint16:
        bshape = (-1,) + (1,) * (images.dim() - 1)
        lo = span[:, 0].reshape(bshape)
        hi = span[:, 1].reshape(bshape)
        scale = (hi - lo) * (1.0 / 65535.0)
        return lo + images.float() * scale
    return images.float()


def pack_train_batch(batch, wire="f32", mask_latch=None):
    """Host-side wire packing of one collated train batch (numpy). With
    wire="u16" the windowed image ships as uint16 plus a per-sample
    (lo, hi) span and the lobe/lesion masks as uint8 when exactly
    representable; wire="f32" ships float32 unchanged."""
    images = batch["#image"][..., None].astype(np.float32)
    lobes = batch["#lobe_reference"][..., None].astype(np.float32)
    lesion_key = "#pseudo_lesion_reference" \
        if "#pseudo_lesion_reference" in batch else "#lesion_reference"
    lesions = batch[lesion_key][..., None].astype(np.float32)
    meta = batch["meta"]
    key = "ctss" if "ctss" in meta else "cle"
    ctss = np.asarray([int(float(c)) for c in meta[key]], np.int32)
    B = images.shape[0]
    span = np.tile(np.array([0.0, 1.0], np.float32), (B, 1))
    if wire == "u16":
        flat = images.reshape(B, -1)
        lo = flat.min(axis=1)
        hi = flat.max(axis=1)
        if not (np.isfinite(lo).all() and np.isfinite(hi).all()):
            # a NaN/Inf cast to u16 is undefined: ship the batch as f32,
            # where the loss shows the NaN
            logging.getLogger(__name__).warning(
                "u16 image wire: batch contains non-finite values; "
                "shipping this batch as f32")
        else:
            hi = np.where(hi > lo, hi, lo + 1.0)
            span = np.stack([lo, hi], axis=1).astype(np.float32)
            bshape = (B,) + (1,) * (images.ndim - 1)
            images = np.rint((images - lo.reshape(bshape)) *
                             (65535.0 / (hi - lo).reshape(bshape))) \
                .astype(np.uint16)
        if mask_latch is None:
            mask_latch = MaskWireLatch()
        lobes = mask_latch.pack(lobes)
        lesions = mask_latch.pack(lesions)
    elif wire != "f32":
        raise ValueError(f"TRAIN_WIRE must be 'f32' or 'u16', got {wire!r}")
    return {"_packed": True, "images": images, "span": span,
            "lobes": lobes, "lesions": lesions, "ctss": ctss}


# --- registry targets of the OPTIMIZER / SCHEDULER settings -------------------


def adam(params, lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
         **kw):
    """OPTIMIZER "torch.optim.Adam": optax's adam, whose update is
    torch.optim.Adam's formula. Weight decay (optax's adamw) is not
    ported: no configuration sets it."""
    if weight_decay:
        raise NotImplementedError(
            f"OPTIMIZER weight_decay={weight_decay!r}: only Adam without "
            "weight decay is ported")
    return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps)


class ExponentialLR:
    """Per-validation-epoch exponential decay (reference SCHEDULER):
    lr = base_lr * gamma ** steps; `apply` writes it into an
    optimizer."""

    def __init__(self, base_lr, gamma=0.9):
        self.base_lr = base_lr
        self.gamma = gamma
        self.steps = 0

    def step(self):
        self.steps += 1

    @property
    def lr(self):
        return self.base_lr * (self.gamma ** self.steps)

    def apply(self, optimizer):
        for group in optimizer.param_groups:
            group["lr"] = self.lr

    def state_dict(self):
        return {"steps": self.steps, "base_lr": self.base_lr,
                "gamma": self.gamma}

    def load_state_dict(self, d):
        self.steps = int(d.get("steps", 0))
        self.base_lr = float(d.get("base_lr", self.base_lr))
        self.gamma = float(d.get("gamma", self.gamma))


def fix_random_seeds(seed):
    """Seed numpy's, Python's and torch's global generators (the host
    augmentations draw from numpy's)."""
    import random
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


# --- the step -------------------------------------------------------------------


class _StageClock:
    """Stage boundaries: CUDA events on the card (read after one
    synchronize), the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def spans_ms(self):
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in
                    zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


class TrainStep:
    """One optimizer step of `model` on one batch: forward through the
    loss (which calls the model via `model_fn`), backward, optimizer
    step. The model's train-mode forward updates the BatchNorm running
    statistics."""

    def __init__(self, model, loss_func, optimizer, loss_factors):
        self.model = model
        self.loss_func = loss_func
        self.optimizer = optimizer
        self.factors = [float(f) for f in loss_factors]

    def __call__(self, images, lobes, lesions, ctss, freq, weights=None,
                 span=None, timed=True):
        """Tensors on the model's device: images (B, D, H, W, 1) f32 or the
        u16 wire with its `span`, lobes and lesions (B, D, H, W, 1),
        ctss (B,) ints, freq (6,) the CTSS frequency map, weights (B,)
        (ones when None). Returns {"losses": (n_losses,) f32, "loss":
        total, "ms": {"forward", "backward", "optimizer"}, "peak_mib"}.
        With timed=False nothing waits for the device ("ms" is None):
        the epoch loop reads the loss a step later."""
        device = images.device
        images = unpack_image_wire(images, span)
        lobes, lesions = lobes.float(), lesions.float()
        if weights is None:
            weights = torch.ones(images.shape[0], device=device)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        clock = _StageClock(device)
        clock.mark()

        def model_fn(im, lo):
            return self.model(im)

        losses = self.loss_func(model_fn, images, lobes, lesions, ctss,
                                ctss_frequency=freq, sample_weight=weights)
        # extra factors are legal (the reference ships 4 for the 2-term
        # IntRegRefineLoss); fewer would silently drop a loss term
        if len(losses) > len(self.factors):
            raise ValueError(
                f"{type(self.loss_func).__name__} returns {len(losses)} "
                f"loss terms but LOSS_FACTORS has only {len(self.factors)} "
                "entries; zip would silently drop a loss from the objective")
        total = sum(l * f for l, f in zip(losses, self.factors))
        clock.mark()
        total.backward()
        clock.mark()
        self.optimizer.step()
        clock.mark()
        ms = None
        if timed:
            fwd, bwd, opt = clock.spans_ms()
            ms = {"forward": fwd, "backward": bwd, "optimizer": opt}
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 20 \
            if device.type == "cuda" else None
        return {"losses": torch.stack([l.detach() for l in losses]),
                "loss": total.detach(), "ms": ms, "peak_mib": peak}


# --- building from settings -----------------------------------------------------


def _method(cfg):
    cfg = dict(cfg)
    return get_callable_by_name(cfg.pop("method")), cfg


# the DC3DATGeneric settings the port's model takes (dram_tpu's names)
_AT_KEYS = ("at_spatial_size", "at_f_dim", "at_g_dim", "at_p_enc_dim",
            "at_g_iter", "at_k_size", "at_merge_type", "at_self_loop",
            "at_layers", "at_connectivity")


def build_model(settings, dtype):
    """DC3D or DC3DATGeneric from settings.MODEL (on the CPU). The port's
    backbone is the shipped one: 3x3x3 SAME convs, no dropout, 2x
    upsampling; its PCM the shipped 'scaled_dot_product_relu' stencil
    attention without positional encoding. Other values raise, naming
    the ROADMAP item that ports them.

    settings.USE_FUSED_STACK (the JAX trainer's name, trainer.py:293-311)
    chooses the fused or the unfused conv stack for the training and the
    eval model alike; it defaults to True, the counterpart of the JAX
    package's accelerator default. USE_PALLAS_CONV only chooses which
    implementation the JAX package runs for the unfused stack's conv (its
    Pallas kernel or XLA's); the port runs its own kernel either way
    (kernels/conv3d.py), so it reads no such setting."""
    cfg = dict(settings.MODEL)
    cls = get_callable_by_name(cfg.pop("method"))
    if cls not in (DC3D, DC3DATGeneric):
        raise NotImplementedError(f"training {cls.__name__} is not ported "
                                  "(ROADMAP Queue 1)")
    if (cfg.get("dropout", 0.0)
            or any(tuple(k) != (3, 3) for k in cfg.get("kernel_sizes", []))
            or any(tuple(p) != (1, 1) for p in cfg.get("padding_list", []))
            or any(f != 2 for f in cfg.get("upsample_sf", (2, 2, 2)))):
        raise NotImplementedError(
            "only the shipped DC3D backbone (3x3x3 SAME convs, no dropout, "
            "2x upsampling) is ported (ROADMAP Queue 1 item 6), got MODEL "
            f"{settings.MODEL!r}")
    common = dict(n_layers=cfg["n_layers"],
                  base_ch_list=tuple(cfg["base_ch_list"]),
                  end_ch_list=tuple(cfg["end_ch_list"]),
                  out_ch=cfg.get("out_ch", 1),
                  stacking=cfg.get("stacking", 0), dtype=dtype,
                  fused_stack=bool(getattr(settings, "USE_FUSED_STACK",
                                           True)))
    if cls is DC3D:
        return DC3D(**common)
    if cfg.get("at_geo_f_dim", 0):
        raise NotImplementedError(
            f"at_geo_f_dim={cfg['at_geo_f_dim']}: the PCM's geo encoding is "
            "not ported (ROADMAP Queue 1 item 6)")
    at = {k: cfg[k] for k in _AT_KEYS if k in cfg}
    for k in ("at_spatial_size", "at_layers"):
        if k in at:
            at[k] = tuple(at[k])
    return DC3DATGeneric(**common, **at)


def build_train_step(settings, device="cuda", weights_path=None):
    """TrainStep for `settings` on `device`: the model from MODEL with
    COMPUTE_DTYPE activations, its parameters from INITIALIZER (a
    torch.Generator seeded with RANDOM_SEED) or, with `weights_path`, the
    trained flagship's tree (DC3DATGeneric: the whole tree; DC3D: its
    backbone); OPTIMIZER and LOSS_FUNC from the port's registry."""
    device = require_cuda(device)
    dtype = torch.bfloat16 \
        if getattr(settings, "COMPUTE_DTYPE", "float32") == "bfloat16" \
        else torch.float32
    model = build_model(settings, dtype)
    if weights_path is not None and isinstance(model, DC3DATGeneric):
        weights.load_into(model, *weights.load_bench_weights(weights_path))
    elif weights_path is not None:
        weights.load_backbone(model, weights_path)
    else:
        init_cls, init_cfg = _method(settings.INITIALIZER)
        gen = torch.Generator().manual_seed(
            int(getattr(settings, "RANDOM_SEED", 33)))
        init_cls(**init_cfg)(model, gen)
    model.to(device)
    opt_fn, opt_cfg = _method(settings.OPTIMIZER)
    loss_cls, loss_cfg = _method(settings.LOSS_FUNC)
    return TrainStep(model, loss_cls(**loss_cfg),
                     opt_fn(model.parameters(), **opt_cfg),
                     settings.LOSS_FACTORS)


def batch_tensors(batch, device, wire="f32"):
    """A collated batch (or one packed by pack_train_batch) -> the
    TrainStep arguments on `device`; the CTSS frequency map comes from
    the batch's "ctss_frequency" when it has one."""
    freq = batch.get("ctss_frequency", DEFAULT_CTSS_FREQUENCY)
    if not batch.get("_packed"):
        batch = pack_train_batch(batch, wire)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {"images": t(batch["images"]), "lobes": t(batch["lobes"]),
            "lesions": t(batch["lesions"]), "ctss": t(batch["ctss"]),
            "freq": t(np.asarray(freq, np.float32)),
            "span": t(batch["span"])}


def train_steps(settings, n_steps, batches, device="cuda", weights_path=None,
                on_step=None):
    """Build a TrainStep from `settings` (build_train_step) and take
    `n_steps` steps over `batches` (collated or packed, cycled). The
    image wire is u16 on the card and f32 on the CPU unless
    settings.TRAIN_WIRE says otherwise. `on_step(i, step, out)`, when
    given, is called after step i. Returns {"losses": per-step (n_losses,)
    lists, "loss": per-step totals, "ms": per-step stage times,
    "peak_mib": per-step peak device memory, "step": the TrainStep}."""
    step = build_train_step(settings, device, weights_path)
    dev = next(step.model.parameters()).device
    wire = str(getattr(settings, "TRAIN_WIRE",
                       "u16" if dev.type == "cuda" else "f32"))
    out = {"losses": [], "loss": [], "ms": [], "peak_mib": [], "step": step}
    for i in range(n_steps):
        r = step(**batch_tensors(batches[i % len(batches)], dev, wire))
        out["losses"].append(r["losses"].tolist())
        out["loss"].append(float(r["loss"]))
        out["ms"].append(r["ms"])
        out["peak_mib"].append(r["peak_mib"])
        if on_step is not None:
            on_step(i, step, r)
    return out

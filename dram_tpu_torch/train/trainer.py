"""One training step of the port and an entry point that drives a few.

Port of the single-device core of dram_tpu/train/trainer.py: the wire
(`unpack_image_wire` :88, `pack_train_batch` :107, `MaskWireLatch` :61),
the optimizer and scheduler registry targets (`adam` :164 with and
without weight decay, `sgd` :172, `ExponentialLR` :177 with its state
:192-200, per-group learning rates :462-480), optimizer groups
(`build_optimizer`: OPTIMIZER["groups"], :326-358), `fix_random_seeds`
(:206)
and the body of `_build_train_step` / `train_step` (:483-578) as
`TrainStep`: the loss drives the model through a `model_fn` closure, the
objective is sum(factor * loss) with the arity check of :533-542, then
the backward through the port's kernels, the optimizer step and the
BatchNorm running-stat update (done by the model's train-mode forward).
Dropout masks and the equivariance losses' transforms draw from the
step's own torch.Generators, seeded from RANDOM_SEED (dram_tpu draws
both from the step's jax.random key: equal distributions, other
draws).
`train_steps` builds model, initializer or weights, optimizer and loss
from a settings module (dram_tpu_torch/configs) and runs a few steps; the
epoch loop is train/chunk_train.py.

Data parallelism (dram_tpu's shard_map step, :483-578): with a process
`group` every rank takes its rows of the padded global batch and their
weights (core/mesh.pad_batch: wrap-around rows of weight 0); the model's
norms and fused stacks carry the group (models/blocks.set_process_group),
so the BatchNorm statistics are the global batch's; the losses sum over
the ranks (core/ops.gsum), so every rank holds the global objective and
its gradient is the world size times its rows' share; after the backward
the gradients are averaged over the ranks once, in one all_reduce over
one flat buffer, which recovers the global gradient exactly (dram_tpu's
single pmean). Initial parameters and buffers come from rank 0.
DistributedDataParallel is not used: its reducer expects one forward per
backward and buckets the parameters it saw, where the equivariance losses
run the model twice a step and TrainStep gives a parameter the loss does
not reach a zero gradient; the explicit mean is the closer match to
dram_tpu's.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .. import require_cuda, tracing, weights
from ..configs import get_callable_by_name
from ..core.mesh import average_gradients, replicate
from ..losses.interval_reg import DEFAULT_CTSS_FREQUENCY
from ..models.blocks import set_process_group
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


def _groups(params):
    """torch.optim's parameter list or list of group dicts, as a list of
    group dicts."""
    params = list(params)
    if params and isinstance(params[0], dict):
        return params
    return [{"params": params}]


def _with_counts(opt):
    """Each group keeps its base lr (ExponentialLR scales it) and the
    count of steps taken (optax's `count`; torch's SGD keeps none)."""
    for g in opt.param_groups:
        g.setdefault("base_lr", g["lr"])
        g.setdefault("count", 0)

    def count(o, args, kwargs):
        for g in o.param_groups:
            g["count"] = int(g.get("count", 0)) + 1
    opt.register_step_post_hook(count)
    return opt


def adam(params, lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
         **kw):
    """OPTIMIZER "torch.optim.Adam": optax's adam, whose update is
    torch.optim.Adam's formula; with weight_decay optax's adamw (mask
    None: every parameter decays), whose update is torch.optim.AdamW's,
    p <- p - lr (adam(g) + wd p). `params` may be parameter-group dicts
    (build_optimizer); when any group decays, AdamW serves every group
    (wd 0: Adam's update)."""
    groups = _groups(params)
    decays = any(g.get("weight_decay", weight_decay) for g in groups)
    cls = torch.optim.AdamW if decays else torch.optim.Adam
    return _with_counts(cls(groups, lr=lr, betas=tuple(betas), eps=eps,
                            weight_decay=weight_decay))


def sgd(params, lr=1e-4, momentum=0.0, **kw):
    """OPTIMIZER "torch.optim.SGD": optax's sgd, momentum None when 0;
    its trace t <- g + momentum t (from 0) is torch.optim.SGD's momentum
    buffer (which starts at g), and the update is -lr t."""
    groups = _groups(params)
    for g in groups:
        g["momentum"] = float(g.get("momentum", momentum) or 0.0)
    return _with_counts(torch.optim.SGD(groups, lr=lr,
                                        momentum=float(momentum or 0.0)))


def group_label(path, keys):
    """The group of a parameter as dram_tpu's label_of_path (:344-350)
    gives it: the first key that is a substring of a component of the
    parameter's flax path, else "__default__"."""
    for key in keys:
        if any(key in c for c in path):
            return key
    return "__default__"


def build_optimizer(model, opt_cfg):
    """The optimizer of OPTIMIZER over `model`'s parameters. With
    "groups" ({key: overrides}, dram_tpu's optax.multi_transform): a
    parameter whose flax path (weights.flax_path) has a component
    containing a key joins that key's group, with the base settings
    updated by its overrides; the rest form "__default__", the first
    group, whose lr the scheduler's base is. Each group carries its
    "label"."""
    fn, cfg = _method(opt_cfg)
    groups = cfg.pop("groups", None)
    if not groups:
        return fn(model.parameters(), **cfg)
    keys = list(groups)
    members = {k: [] for k in ["__default__"] + keys}
    for name, p in model.named_parameters():
        members[group_label(weights.flax_path(name, p.dim()),
                            keys)].append(p)
    param_groups = [dict({"params": ps, "label": k}, **dict(groups.get(k,
                                                                      {})))
                    for k, ps in members.items()]
    return fn(param_groups, **cfg)


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
        """Every group's lr = its base lr scaled by the same decay factor
        (dram_tpu's _set_lr; torch's ExponentialLR multiplies each
        group's lr by gamma)."""
        scale = self.lr / self.base_lr if self.base_lr else 0.0
        for group in optimizer.param_groups:
            base = group.get("base_lr")
            group["lr"] = self.lr if base is None else base * scale

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


class TrainStep:
    """One optimizer step of `model` on one batch: forward through the
    loss (which calls the model via `model_fn`), backward, optimizer
    step. The model's train-mode forward updates the BatchNorm running
    statistics. With a process `group` the step is the data-parallel one
    (see the module's docstring): the model's norms get the group and
    rank 0's parameters and buffers."""

    def __init__(self, model, loss_func, optimizer, loss_factors, seed=33,
                 group=None):
        self.model = model
        self.loss_func = loss_func
        self.optimizer = optimizer
        self.factors = [float(f) for f in loss_factors]
        self.group = group
        set_process_group(model, group)
        replicate(model, group)
        device = next(model.parameters()).device
        # dropout masks (on the model's device) and the loss's transform
        # decisions (host) draw from these, step after step
        self.dropout_gen = torch.Generator(device=device).manual_seed(seed)
        self.transform_gen = torch.Generator().manual_seed(seed)

    def __call__(self, images, lobes, lesions, ctss, freq, weights=None,
                 span=None, timed=True):
        """Tensors on the model's device: images (B, D, H, W, 1) f32 or the
        u16 wire with its `span`, lobes and lesions (B, D, H, W, 1),
        ctss (B,) ints, freq (6,) the CTSS frequency map, weights (B,)
        (ones when None); under data parallelism this rank's rows of the
        padded global batch and their weights. Returns {"losses":
        (n_losses,) f32, "loss": total, "ms": {"forward", "backward",
        "optimizer"}, "peak_mib"}.

        The step is one tracer unit `step` (dram_tpu_torch.tracing) with
        the spans `unpack` (the wire), `loss` (the loss, its `model`
        calls inside), `backward` (the gradient fill and the ranks'
        average included) and `optimizer`. "ms" holds the device ms of
        loss, backward and optimizer (CUDA events on the card, read
        after one synchronize; the host ms on the CPU). With timed=False
        the tracer is left as it is (off unless a profiler records) and
        nothing waits for the device ("ms" is None): the epoch loop
        reads the loss a step later."""
        device = images.device
        with tracing.unit("step", force=timed) as step:
            with tracing.span("unpack", device):
                images = unpack_image_wire(images, span)
                lobes, lesions = lobes.float(), lesions.float()
                if weights is None:
                    weights = torch.ones(images.shape[0], device=device)
            self.model.train()
            self.optimizer.zero_grad(set_to_none=True)
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)

            if hasattr(self.model, "set_dropout_generator"):
                self.model.set_dropout_generator(self.dropout_gen)

            def model_fn(im, lo):
                with tracing.span("model", device):
                    return self.model(im)

            with tracing.span("loss", device):
                losses = self.loss_func(
                    model_fn, images, lobes, lesions, ctss,
                    ctss_frequency=freq, rng=self.transform_gen,
                    sample_weight=weights, group=self.group)
                # extra factors are legal (the reference ships 4 for the
                # 2-term IntRegRefineLoss); fewer would silently drop a
                # loss term
                if len(losses) > len(self.factors):
                    raise ValueError(
                        f"{type(self.loss_func).__name__} returns "
                        f"{len(losses)} loss terms but LOSS_FACTORS has only "
                        f"{len(self.factors)} entries; zip would silently "
                        "drop a loss from the objective")
                total = sum(l * f for l, f in zip(losses, self.factors))
            with tracing.span("backward", device):
                total.backward()
                # optax updates every parameter, a zero gradient included
                # (Adam's moments decay, AdamW decays the weight): a
                # parameter the loss does not reach (the PCM under
                # IntRegAffLoss) gets a zero one
                for p in self.model.parameters():
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                average_gradients(self.model.parameters(), self.group)
            with tracing.span("optimizer", device):
                self.optimizer.step()
        ms = None
        if timed:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            ms = {"forward": step.device_ms_of("loss"),
                  "backward": step.device_ms_of("backward"),
                  "optimizer": step.device_ms_of("optimizer")}
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 20 \
            if device.type == "cuda" else None
        return {"losses": torch.stack([l.detach() for l in losses]),
                "loss": total.detach(), "ms": ms, "peak_mib": peak}


# --- building from settings -----------------------------------------------------


def _method(cfg):
    cfg = dict(cfg)
    return get_callable_by_name(cfg.pop("method")), cfg


# MODEL settings that dram_tpu's modules take and use for no value
# (flax infers input widths; remat changes no value; the upsample kernel
# size and the class count are unused fields)
_UNUSED_KEYS = ("in_ch_list", "checkpoint_layers", "upsample_ksize",
                "out_cls_ch")


def build_model(settings, dtype):
    """DC3D or DC3DATGeneric from settings.MODEL (on the CPU), with every
    option dram_tpu's modules take: the backbone's (kernel_sizes,
    padding_list, norm_method, act_method, dropout, upsample_sf,
    local_upsample) and the PCM's (at_*: any stencil, merge type,
    widths, positional encoding). A key neither module has raises
    TypeError, as flax does.

    settings.USE_FUSED_STACK (the JAX trainer's name, trainer.py:293-311)
    chooses the fused or the unfused conv stack for the training and the
    eval model alike (a stack the fused kernels do not compute runs
    unfused either way); it defaults to True, the counterpart of the JAX
    package's accelerator default. USE_PALLAS_CONV only chooses which
    implementation the JAX package runs for the unfused stack's conv (its
    Pallas kernel or XLA's); the port runs its own kernel either way
    (kernels/conv3d.py), so it reads no such setting."""
    cfg = dict(settings.MODEL)
    cls = get_callable_by_name(cfg.pop("method"))
    if cls not in (DC3D, DC3DATGeneric):
        raise NotImplementedError(f"training {cls.__name__} is not ported "
                                  "(ROADMAP Queue 1)")
    for k in _UNUSED_KEYS:
        cfg.pop(k, None)
    for k in ("at_spatial_size", "at_layers"):
        if k in cfg:
            cfg[k] = tuple(cfg[k])
    return cls(**cfg, dtype=dtype,
               fused_stack=bool(getattr(settings, "USE_FUSED_STACK", True)))


def build_train_step(settings, device="cuda", weights_path=None,
                     backbone_only=False, group=None):
    """TrainStep for `settings` on `device`: the model from MODEL with
    COMPUTE_DTYPE activations, its parameters from INITIALIZER (a
    torch.Generator seeded with RANDOM_SEED) or, with `weights_path`, the
    trained flagship's tree (DC3DATGeneric: the whole tree, or with
    `backbone_only` its backbone over INITIALIZER's tap heads and PCM;
    DC3D: its backbone); OPTIMIZER and LOSS_FUNC from the port's
    registry; a process `group` makes it the data-parallel step."""
    device = require_cuda(device)
    dtype = torch.bfloat16 \
        if getattr(settings, "COMPUTE_DTYPE", "float32") == "bfloat16" \
        else torch.float32
    model = build_model(settings, dtype)
    if weights_path is None or backbone_only:
        init_cls, init_cfg = _method(settings.INITIALIZER)
        gen = torch.Generator().manual_seed(
            int(getattr(settings, "RANDOM_SEED", 33)))
        init_cls(**init_cfg)(model, gen)
    if weights_path is not None and isinstance(model, DC3DATGeneric):
        if backbone_only:
            weights.load_backbone(model.backbone, weights_path)
        else:
            weights.load_into(model,
                              *weights.load_bench_weights(weights_path))
    elif weights_path is not None:
        weights.load_backbone(model, weights_path)
    model.to(device)
    loss_cls, loss_cfg = _method(settings.LOSS_FUNC)
    return TrainStep(model, loss_cls(**loss_cfg),
                     build_optimizer(model, settings.OPTIMIZER),
                     settings.LOSS_FACTORS,
                     int(getattr(settings, "RANDOM_SEED", 33)), group)


def batch_tensors(batch, device, wire="f32"):
    """A collated batch (or one packed by pack_train_batch) -> the
    TrainStep arguments on `device`; the CTSS frequency map comes from
    the batch's "ctss_frequency" when it has one, the sample weights from
    its "weights" (ones when it has none)."""
    freq = batch.get("ctss_frequency", DEFAULT_CTSS_FREQUENCY)
    sample_weights = batch.get("weights")
    if not batch.get("_packed"):
        batch = pack_train_batch(batch, wire)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    out = {"images": t(batch["images"]), "lobes": t(batch["lobes"]),
           "lesions": t(batch["lesions"]), "ctss": t(batch["ctss"]),
           "freq": t(np.asarray(freq, np.float32)),
           "span": t(batch["span"])}
    if sample_weights is not None:
        out["weights"] = t(np.asarray(sample_weights, np.float32))
    return out


def train_steps(settings, n_steps, batches, device="cuda", weights_path=None,
                on_step=None, backbone_only=False, group=None):
    """Build a TrainStep from `settings` (build_train_step) and take
    `n_steps` steps over `batches` (collated or packed, cycled). The
    image wire is u16 on the card and f32 on the CPU unless
    settings.TRAIN_WIRE says otherwise. `on_step(i, step, out)`, when
    given, is called after step i. Returns {"losses": per-step (n_losses,)
    lists, "loss": per-step totals, "ms": per-step stage times,
    "peak_mib": per-step peak device memory, "step": the TrainStep}.
    `backbone_only` as in build_train_step. A loss with an epoch-static
    transform (the equivariance losses) is reseeded before each step as
    the epoch loop reseeds it in epoch 0. With a process `group` the
    batches are this rank's rows (with their "weights") and the steps
    are data parallel."""
    step = build_train_step(settings, device, weights_path, backbone_only,
                            group)
    dev = next(step.model.parameters()).device
    wire = str(getattr(settings, "TRAIN_WIRE",
                       "u16" if dev.type == "cuda" else "f32"))
    out = {"losses": [], "loss": [], "ms": [], "peak_mib": [], "step": step}
    seed = int(getattr(settings, "RANDOM_SEED", 33))
    for i in range(n_steps):
        if hasattr(step.loss_func, "epoch_reseed"):
            # the rescale's size for step i of epoch 0, as the epoch loop
            # draws it (chunk_train.py)
            step.loss_func.epoch_reseed(seed + 104729 * i)
        r = step(**batch_tensors(batches[i % len(batches)], dev, wire))
        out["losses"].append(r["losses"].tolist())
        out["loss"].append(float(r["loss"]))
        out["ms"].append(r["ms"])
        out["peak_mib"].append(r["peak_mib"])
        if on_step is not None:
            on_step(i, step, r)
    return out

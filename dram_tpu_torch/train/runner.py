"""Runner scaffolding: settings, logging, output paths, the model, its
training objects, checkpoints and their reload.

Port of dram_tpu/train/trainer.py:JobRunner (:213-640): the settings, `logging.config.dictConfig(LOGGING)` (basicConfig without
one), `exp_path` / `debug_path` and their settings.txt; `init` (the
model of MODEL through build_model, with COMPUTE_DTYPE activations,
initialised from RANDOM_SEED by an explicit torch.Generator);
`init_training` (the optimizer of OPTIMIZER, the ExponentialLR of
SCHEDULER, the loss of LOSS_FUNC, the TrainStep and the SummaryWriter);
`print_model_parameters` (:435), `update_model_state` / `save_model`
(`{epoch}.ckpt`, :580-600) and `reload_model_from_cache` (:602; model,
optimizer, scheduler and metrics). One nn.Module serves training and
validation: the JAX runner's two flax modules over one parameter tree
(:303-313) become its train and eval modes, so no weights are copied.

Under torchrun (core/mesh.maybe_init_distributed) the runner is one rank
of a data-parallel run (:372-418): TrainStep gets the process group;
DP_BATCH_MODE "pad" keeps TRAIN_BATCH_SIZE as the global batch and pads
it to the world with weight-0 rows, "scale" makes it B x world;
DCN_MESH_SIZE must divide the world (the flat rank order is best_mesh's
(dcn, ici) order); PER_PROCESS_LOADING (on by default above one rank)
makes each rank load only its rows of the global batch. Only rank 0
writes settings.txt, scalars and checkpoints; every rank reads a
checkpoint it reloads. Optimizer groups (OPTIMIZER["groups"]) are
trainer.build_optimizer's.
"""

from __future__ import annotations

import logging
import logging.config
import os

import numpy as np
import torch

from .. import require_cuda, weights
from ..configs import get_callable_by_name
from ..core.mesh import (check_dcn_size, data_group, is_writer,
                         local_batch_rows, rank, world_size)
from ..utils import Settings, get_value_recursively
from ..viz import SummaryWriter
from .checkpoint import (load_checkpoint, load_optimizer_state,
                         newest_checkpoint, optimizer_state_tree,
                         save_checkpoint, tolerant_merge)
from .trainer import ExponentialLR, TrainStep, build_model, build_optimizer


def rank_rows(world, rank_, batch):
    """Per-rank loading of a global batch of `batch` rows: (((lo, hi) of
    the padded batch this rank owns, the padded size, its real row
    count), the rows [lo, hi) its loader reads: clipped to the batch, at
    least one; a rank that owns only padding reads the batch's last row,
    at weight 0, where dram_tpu's slice would be empty)."""
    (lo, hi), padded = local_batch_rows(world, rank_, batch)
    lo_eff, hi_eff = min(lo, batch), min(hi, batch)
    lo_load = min(lo_eff, batch - 1)
    return (((lo, hi), padded, hi_eff - lo_eff),
            (lo_load, max(hi_eff, lo_load + 1)))


class _NoWriter:
    """The summary writer of a rank that writes nothing."""

    def add_scalars(self, *args, **kwargs):
        pass

    add_scalar = add_histogram = add_scalars


class JobRunner:
    """Settings, logging and output paths of one experiment on `device`
    (default "cuda"; raises when CUDA is asked for and absent).
    `settings` is a Settings, a settings file's path, a settings module
    or a with_settings namespace."""

    def __init__(self, settings, device="cuda"):
        self.settings = settings if isinstance(settings, Settings) \
            else Settings(settings)
        self.device = require_cuda(device)
        self.group = data_group()
        self.writer = is_writer(self.group)
        s = self.settings
        log_cfg = getattr(s, "LOGGING", None)
        for fn in get_value_recursively(log_cfg or {}, "filename"):
            os.makedirs(os.path.dirname(fn), exist_ok=True)
        if log_cfg:
            logging.config.dictConfig(log_cfg)
        else:
            logging.basicConfig(
                level=logging.INFO,
                format="%(asctime)s [%(levelname)s] %(name)s: %(message)s")
        self.logger = logging.getLogger(s.EXP_NAME)

        self.exp_path = os.path.join(s.MODEL_ROOT_PATH, s.EXP_NAME) + "/"
        self.debug_path = os.path.join(s.DEBUG_PATH, s.EXP_NAME) + "/"
        os.makedirs(self.exp_path, exist_ok=True)
        os.makedirs(self.debug_path, exist_ok=True)
        self.model_metrics_save_dict = {}
        self.epoch_n = 0
        self.current_iteration = 0
        self.optimizer = self.scheduler = None
        if self.writer:
            with open(self.exp_path + "/settings.txt", "wt",
                      newline="") as fp:
                fp.write(str(s))

    def init(self):
        """The model of settings.MODEL in eval mode on the device, its
        parameters drawn by INITIALIZER from RANDOM_SEED."""
        s = self.settings
        dtype = torch.bfloat16 \
            if getattr(s, "COMPUTE_DTYPE", "float32") == "bfloat16" \
            else torch.float32
        model = build_model(s, dtype)
        init_cfg = dict(getattr(s, "INITIALIZER", {"method": "models.HeNorm"}))
        init_cls = get_callable_by_name(init_cfg.pop("method"))
        gen = torch.Generator().manual_seed(int(getattr(s, "RANDOM_SEED", 33)))
        init_cls(**init_cfg)(model, gen)
        self.model = model.to(self.device).eval()

    def init_training(self):
        """After init: the optimizer, scheduler (its lr written into the
        optimizer), loss, TrainStep, train wire and SummaryWriter."""
        s = self.settings
        world = world_size(self.group)
        check_dcn_size(getattr(s, "DCN_MESH_SIZE", None), world)
        mode = getattr(s, "DP_BATCH_MODE", "pad")
        if mode not in ("pad", "scale"):
            raise ValueError(f"DP_BATCH_MODE must be 'pad' or 'scale', "
                             f"got {mode!r}")
        self.train_wire = str(getattr(s, "TRAIN_WIRE", "f32"))
        if self.train_wire not in ("f32", "u16"):
            raise ValueError(f"TRAIN_WIRE must be 'f32' or 'u16', "
                             f"got {self.train_wire!r}")
        b = int(getattr(s, "TRAIN_BATCH_SIZE", 1))
        self.loader_batch_size = b * world if mode == "scale" else b
        self._local_rows = self._loader_row_range = None
        if world > 1 and bool(getattr(s, "PER_PROCESS_LOADING", True)):
            self._local_rows, self._loader_row_range = rank_rows(
                world, rank(self.group), self.loader_batch_size)
        if world > 1:
            self.logger.info(
                f"data parallel over {world} ranks (batch mode {mode}, "
                f"global batch {self.loader_batch_size}, loader rows "
                f"{self._loader_row_range or 'all'})")

        self.optimizer = build_optimizer(self.model, s.OPTIMIZER)
        sched_cfg = dict(getattr(s, "SCHEDULER", {
            "method": "torch.optim.lr_scheduler.ExponentialLR",
            "gamma": 0.9}))
        method = sched_cfg.pop("method")
        if get_callable_by_name(method) is not ExponentialLR:
            raise NotImplementedError(
                f"SCHEDULER method {method!r}: dram_tpu checks that the name "
                "resolves, then decays the learning rate exponentially "
                "whatever it names (dram_tpu/train/trainer.py:361-365); the "
                "port refuses a scheduler other than ExponentialLR rather "
                "than run another schedule without a word")
        self.scheduler = ExponentialLR(self.optimizer.param_groups[0]["lr"],
                                       **sched_cfg)
        self.scheduler.apply(self.optimizer)
        loss_cfg = dict(s.LOSS_FUNC)
        self.loss_func = get_callable_by_name(loss_cfg.pop("method"))(
            **loss_cfg)
        self.train_step = TrainStep(self.model, self.loss_func,
                                    self.optimizer, s.LOSS_FACTORS,
                                    int(getattr(s, "RANDOM_SEED", 33)),
                                    self.group)
        if getattr(s, "USE_GRAD_SCALER", False):
            self.logger.info("USE_GRAD_SCALER requested: bf16 keeps the f32 "
                             "exponent range, no loss scaling; ignored")
        self.summary_writer = SummaryWriter(
            log_dir=os.path.join(self.exp_path, "summary")) \
            if self.writer else _NoWriter()

    def print_model_parameters(self, iteration):
        """Per-parameter histogram and mean / std scalars, under the flax
        names joined by "_"."""
        params, _ = weights.to_jax(dict(self.model.named_parameters()))

        def flat(tree, prefix=""):
            for k, v in tree.items():
                if isinstance(v, dict):
                    yield from flat(v, f"{prefix}{k}_")
                else:
                    yield prefix + k, v
        for name, arr in flat(params):
            self.summary_writer.add_histogram(name, arr, iteration)
            self.summary_writer.add_scalar(f"mean_{name}", float(arr.mean()),
                                           iteration)
            self.summary_writer.add_scalar(f"std_{name}", float(arr.std()),
                                           iteration)

    # -- checkpoints ---------------------------------------------------
    def model_state_tree(self):
        params, batch_stats = weights.to_jax(self.model.state_dict())
        return {"params": params, "batch_stats": batch_stats}

    def update_model_state(self, **kwargs):
        """The checkpoint tree, in the JAX trainer's layout: epoch,
        iteration, model, optimizer (optax's state layout), scheduler and
        metrics."""
        state = {"epoch": self.epoch_n,
                 "iteration": self.current_iteration,
                 "model": self.model_state_tree(),
                 "optimizer": optimizer_state_tree(self.optimizer,
                                                   self.model),
                 "scheduler": self.scheduler.state_dict(),
                 "metrics": dict(self.model_metrics_save_dict)}
        state.update(kwargs)
        return state

    def save_model(self, **kwargs):
        """`{epoch}.ckpt` under exp_path (rank 0 writes it)."""
        path = os.path.join(self.exp_path, f"{self.epoch_n}.ckpt")
        if not self.writer:
            return path
        save_checkpoint(path, self.update_model_state(**kwargs))
        self.logger.info(f"saved model into {path}.")
        return path

    def reload_model_from_cache(self):
        """With RELOAD_CHECKPOINT, load RELOAD_CHECKPOINT_PATH (else the
        newest checkpoint of exp_path; raises when there is none): the
        entries of RELOAD_DICT_LIST ("model" through tolerant_merge: saved
        arrays of another shape, or missing, keep the model's;
        "optimizer" into the optimizer of init_training; "metrics"), the
        scheduler's state whenever the checkpoint has one and a scheduler
        exists, and the epoch and iteration."""
        s = self.settings
        if not getattr(s, "RELOAD_CHECKPOINT", False):
            self.epoch_n = 0
            self.current_iteration = 0
            return
        cpk_path = getattr(s, "RELOAD_CHECKPOINT_PATH", None)
        if cpk_path is None:
            cpk_path = newest_checkpoint(self.exp_path)
            if cpk_path is None:
                raise RuntimeError(f"{self.exp_path} has no checkpoint files.")
        self.logger.info(f"reloading model from {cpk_path}.")
        saved = load_checkpoint(cpk_path)

        reload_keys = getattr(s, "RELOAD_DICT_LIST", ["model"])
        if "model" in reload_keys and "model" in saved:
            merged = tolerant_merge(self.model_state_tree(), saved["model"],
                                    log=self.logger.info)
            weights.load_into(self.model, merged["params"],
                              merged["batch_stats"])
            self.logger.info("=> loaded model")
        if "optimizer" in reload_keys and "optimizer" in saved \
                and self.optimizer is not None:
            try:
                load_optimizer_state(self.optimizer, self.model,
                                     saved["optimizer"])
                self.logger.info("=> loaded optimizer")
            except (KeyError, ValueError) as e:
                self.logger.warning(f"optimizer reload failed ({e}); fresh "
                                    "state")
        if "metrics" in reload_keys and "metrics" in saved:
            self.model_metrics_save_dict.update(saved["metrics"])
        if "scheduler" in saved and self.scheduler is not None:
            self.scheduler.load_state_dict(saved["scheduler"])
            self.scheduler.apply(self.optimizer)
        self.epoch_n = int(np.asarray(saved.get("epoch", 0)))
        self.current_iteration = int(np.asarray(saved.get("iteration", 0)))

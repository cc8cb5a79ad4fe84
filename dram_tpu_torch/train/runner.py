"""Runner scaffolding: settings, logging, output paths, the model and its
reload from a checkpoint.

Port of the part of dram_tpu/train/trainer.py:JobRunner (:213) that the
inference engine uses: the settings, `logging.config.dictConfig(LOGGING)`
(basicConfig without one), `exp_path` / `debug_path` and their
settings.txt, `init` (the model of MODEL through build_model, with
COMPUTE_DTYPE activations, initialised from RANDOM_SEED by an explicit
torch.Generator) and `reload_model_from_cache` (:602). The optimizer, the
scheduler and the epoch loop belong to the trainer (ROADMAP Queue 1 item
3): a checkpoint's optimizer and scheduler states are skipped.
"""

from __future__ import annotations

import logging
import logging.config
import os

import torch

from .. import require_cuda, weights
from ..configs import get_callable_by_name
from ..utils import Settings, get_value_recursively
from .checkpoint import load_checkpoint, newest_checkpoint, tolerant_merge
from .trainer import build_model


class JobRunner:
    """Settings, logging and output paths of one experiment on `device`
    (default "cuda"; raises when CUDA is asked for and absent).
    `settings` is a Settings, a settings file's path, a settings module
    or a with_settings namespace."""

    def __init__(self, settings, device="cuda"):
        self.settings = settings if isinstance(settings, Settings) \
            else Settings(settings)
        self.device = require_cuda(device)
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
        with open(self.exp_path + "/settings.txt", "wt", newline="") as fp:
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

    def reload_model_from_cache(self):
        """With RELOAD_CHECKPOINT, load RELOAD_CHECKPOINT_PATH (else the
        newest checkpoint of exp_path; raises when there is none): the
        entries of RELOAD_DICT_LIST, the model's through tolerant_merge
        (saved arrays of another shape, or missing, keep the model's),
        and the epoch and iteration."""
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
            params, batch_stats = weights.to_jax(self.model.state_dict())
            merged = tolerant_merge(
                {"params": params, "batch_stats": batch_stats},
                saved["model"], log=self.logger.info)
            weights.load_into(self.model, merged["params"],
                              merged["batch_stats"])
            self.logger.info("=> loaded model")
        for key in ("optimizer", "scheduler"):
            if key in saved:
                self.logger.info(f"skipping the checkpoint's {key} state: "
                                 "the port's trainer does not reload it yet")
        if "metrics" in reload_keys and "metrics" in saved:
            self.model_metrics_save_dict.update(saved["metrics"])
        self.epoch_n = int(saved.get("epoch", 0))
        self.current_iteration = int(saved.get("iteration", 0))

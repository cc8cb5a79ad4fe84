"""Experiment settings of the port (copies of dram_tpu/configs) and the
resolution of their method names into the port's own classes."""

from __future__ import annotations

import importlib
import types

# reference-style method names -> the port's callables (every name of the
# JAX package's dram_tpu/utils.py:_ALIASES)
_ALIASES = {
    "models.DC3D": "dram_tpu_torch.models.unet3d.DC3D",
    "models.DC3DATGeneric": "dram_tpu_torch.models.dc3d_at.DC3DATGeneric",
    "models.HeNorm": "dram_tpu_torch.models.initializers.HeNorm",
    "models.PCM": "dram_tpu_torch.models.pcm.PCM",
    "metrics.IntRegLoss": "dram_tpu_torch.losses.interval_reg.IntRegLoss",
    "metrics.IntRegRefineLoss": "dram_tpu_torch.losses.refine.IntRegRefineLoss",
    "metrics.IntRegAffLoss":
        "dram_tpu_torch.losses.equivariance.IntRegAffLoss",
    "metrics.IntRegAffRefineLoss":
        "dram_tpu_torch.losses.equivariance.IntRegAffRefineLoss",
    "metrics.BootBinCrossEntropy":
        "dram_tpu_torch.losses.bootstrap_bce.BootBinCrossEntropy",
    "metrics.BinaryCrossEntropySmooth":
        "dram_tpu_torch.losses.bootstrap_bce.BinaryCrossEntropySmooth",
    "torch.optim.Adam": "dram_tpu_torch.train.trainer.adam",
    "torch.optim.SGD": "dram_tpu_torch.train.trainer.sgd",
    "torch.optim.lr_scheduler.ExponentialLR":
        "dram_tpu_torch.train.trainer.ExponentialLR",
    "job_runner.LesionSegTest": "dram_tpu_torch.infer.engine.LesionSegTest",
    "job_runner.LesionSegChunkTrain":
        "dram_tpu_torch.train.chunk_train.LesionSegChunkTrain",
}


def get_callable_by_name(name):
    """A config's method name -> the port's callable. Names outside the
    table must already name a dram_tpu_torch object."""
    target = _ALIASES.get(name, name)
    if not target.startswith("dram_tpu_torch."):
        raise KeyError(f"method {name!r} has no counterpart in "
                       "dram_tpu_torch")
    module_name, _, attr = target.rpartition(".")
    return getattr(importlib.import_module(module_name), attr)


def register_alias(name, target):
    """Make `name` resolve to `target` (a dotted dram_tpu_torch path) in
    get_callable_by_name."""
    _ALIASES[name] = target


def with_settings(settings, **values):
    """A copy of a settings module's upper-case names with `values` set on
    it, e.g. with_settings(st_dram_ref_att, USE_FUSED_STACK=False): a
    variant built in code, since the port keeps no settings file that
    dram_tpu/configs lacks."""
    copy = types.SimpleNamespace(**{k: getattr(settings, k)
                                    for k in dir(settings) if k.isupper()})
    for k, v in values.items():
        setattr(copy, k, v)
    return copy

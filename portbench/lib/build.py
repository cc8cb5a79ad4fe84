"""The system under test built from a configuration file: the port's
settings module with the file's values set on it, its model, and the
parameters the harness makes or reads and hands to the port and to the
reference alike."""

import importlib
import math
import os

import torch

from . import flaxckpt
from .harness import ROOT


def settings(cfg):
    from dram_tpu_torch.configs import with_settings
    module = importlib.import_module(cfg["settings"])
    return with_settings(module, **cfg["values"])


def dtype(cfg):
    return torch.bfloat16 if cfg["values"].get("COMPUTE_DTYPE") \
        == "bfloat16" else torch.float32


def seeded_state(shapes, seed, device):
    """Parameters and buffers from `seed`, by name and shape, in a few
    draws on `device`: 3x3x3 conv kernels N(0, 2 / fan_in) (HeNorm,
    fan_in); 1x1x1 conv kernels N(0, 1 / fan_in) clipped at two standard
    deviations and zero biases; dense layers U(+-1 / sqrt(fan_in)),
    biases too; BatchNorm scale 1, shift 0, running mean 0, running
    variance 1."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    normal, uniform, out = [], [], {}
    for name, shape in shapes.items():
        mod, leaf = name.rsplit(".", 1)
        wshape = shapes.get(f"{mod}.weight", shape)
        fan_in = math.prod(wshape[1:]) if len(wshape) > 1 else 1
        if leaf == "running_mean" or (leaf == "bias" and len(wshape) != 2):
            out[name] = torch.zeros(shape, device=device)
        elif leaf == "running_var" or (leaf == "weight" and len(shape) == 1):
            out[name] = torch.ones(shape, device=device)
        elif len(wshape) == 2:
            uniform.append((name, shape, 1.0 / math.sqrt(fan_in)))
        else:
            k = wshape[2] if len(wshape) == 5 else 1
            std = math.sqrt((2.0 if k == 3 else 1.0) / fan_in)
            normal.append((name, shape, std, k != 3))
    n = sum(math.prod(s) for _, s, _, _ in normal)
    flat = torch.randn(n, generator=gen, device=device)
    at = 0
    for name, shape, std, clip in normal:
        c = math.prod(shape)
        t = flat[at:at + c].reshape(shape)
        out[name] = (t.clamp(-2.0, 2.0) if clip else t) * std
        at += c
    n = sum(math.prod(s) for _, s, _ in uniform)
    flat = torch.rand(n, generator=gen, device=device) * 2.0 - 1.0
    at = 0
    for name, shape, bound in uniform:
        c = math.prod(shape)
        out[name] = flat[at:at + c].reshape(shape) * bound
        at += c
    return {k: out[k].float().contiguous() for k in shapes}


def model_and_state(cfg, seed, device):
    """(the port's model on `device` holding the state, the state
    {name: f32 tensor on device}). The state is the trained checkpoint
    the file names under "weights", or seeded_state when it says
    "seed"."""
    from dram_tpu_torch.train.trainer import build_model
    s = settings(cfg)
    model = build_model(s, dtype(cfg))
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    if cfg["weights"] == "seed":
        state = seeded_state(shapes, seed, device)
    else:
        sd = flaxckpt.state_dict_np(os.path.join(ROOT, cfg["weights"]))
        state = {k: torch.from_numpy(sd[k]).to(device) for k in shapes}
    model.load_state_dict(state, strict=True)
    return model.to(device), state

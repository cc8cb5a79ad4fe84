"""Checkpoints: flax msgpack trees with a tolerant, shape-checked restore.

Port of dram_tpu/train/checkpoint.py (`save_checkpoint` :20,
`load_checkpoint` :30, `newest_checkpoint` :35, `tolerant_merge` :58) in
the same format, flax msgpack of nested dicts of arrays, read and written
by the port's own codec (weights.msgpack_unpackb / msgpack_packb), so
that dram_tpu's checkpoints load in the port and the port's in dram_tpu.
Trees hold flax names and layouts: weights.to_jax maps a model's
state_dict into one, weights.load_into back.

`adam_state_tree` / `load_adam_state` map torch.optim.Adam's state to and
from the tree that flax.serialization.to_state_dict makes of the JAX
trainer's optax `inject_hyperparams(adam)` state (its checkpoints'
"optimizer" entry): `count` (int32), `hyperparams` (learning_rate, b1,
b2, eps, eps_root as f32 scalars), `hyperparams_states` {} and
`inner_state` {"0": {count, mu, nu}, "1": {}}, with mu and nu in the
parameters' flax names and layouts. Torch's per-parameter step,
exp_avg and exp_avg_sq are optax's count, mu and nu.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from ..weights import from_jax, msgpack_packb, msgpack_unpackb, to_jax


def save_checkpoint(path, tree):
    """Atomically write a nested dict of arrays as flax msgpack."""
    data = msgpack_packb(tree)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as fp:
        fp.write(data)
    os.replace(tmp, path)


def load_checkpoint(path):
    with open(path, "rb") as fp:
        return msgpack_unpackb(fp.read())


def newest_checkpoint(exp_path, pattern="*.ckpt"):
    """The checkpoint to resume from in a directory; None if there is none.

    Ranks by the epoch number of a ``{epoch}.ckpt`` stem; files with
    other names rank below every epoch-named one, newest ctime first.
    """
    files = glob.glob(os.path.join(exp_path, pattern))
    if not files:
        return None

    def rank(path):
        stem = os.path.splitext(os.path.basename(path))[0]
        try:
            return (1, int(stem), 0.0)
        except ValueError:
            return (0, 0, os.path.getctime(path))

    return max(files, key=rank)


def tolerant_merge(current, saved, ignored_keys=(), overwrite=False,
                   log=None, _prefix=""):
    """Merge `saved` into `current` (both nested dicts), keeping the
    current entry where the saved one is missing, ignored or of another
    shape (each logged through `log`); with `overwrite`, saved entries
    replace current ones wholesale. Returns a new tree."""
    if overwrite:
        out = dict(current) if isinstance(current, dict) else {}
        out.update(saved)
        return out
    if not isinstance(current, dict) or not isinstance(saved, dict):
        return current
    out = {}
    for k, cv in current.items():
        key = f"{_prefix}{k}"
        if k not in saved:
            out[k] = cv
            continue
        sv = saved[k]
        if key in ignored_keys or k in ignored_keys:
            if log:
                log(f"ignore key: {key}")
            out[k] = cv
        elif isinstance(cv, dict):
            out[k] = tolerant_merge(cv, sv, ignored_keys, False, log,
                                    _prefix=key + "/")
        elif hasattr(cv, "shape"):
            if hasattr(sv, "shape") and \
                    tuple(np.shape(sv)) == tuple(np.shape(cv)):
                out[k] = np.asarray(sv).astype(np.asarray(cv).dtype)
            else:
                if log:
                    log(f"in {key}, saved shape {np.shape(sv)} does not "
                        f"match current shape {np.shape(cv)}")
                out[k] = cv
        else:
            out[k] = sv
    return out


def _named_params(optimizer, model):
    """(name, parameter) of `model` in the order of the optimizer's one
    parameter group, which must hold exactly the model's parameters."""
    named = list(model.named_parameters())
    groups = optimizer.param_groups
    if len(groups) != 1 or len(groups[0]["params"]) != len(named) or any(
            p is not q for p, (_, q) in zip(groups[0]["params"], named)):
        raise ValueError("the optimizer must hold the model's parameters "
                         "in one group, in the model's order")
    return named


def adam_state_tree(optimizer, model):
    """torch.optim.Adam's state over `model`'s parameters -> the flax
    state dict of optax's inject_hyperparams(adam) state (numpy)."""
    named = _named_params(optimizer, model)
    group = optimizer.param_groups[0]
    mu, nu, count = {}, {}, 0
    for name, p in named:
        st = optimizer.state.get(p) or {}
        mu[name] = st.get("exp_avg", torch.zeros_like(p))
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(p))
        count = int(st["step"]) if "step" in st else 0
    mu_tree, nu_tree = to_jax(mu)[0], to_jax(nu)[0]
    b1, b2 = group["betas"]
    f32 = np.float32
    return {"count": np.asarray(count, np.int32),
            "hyperparams": {"learning_rate": np.asarray(group["lr"], f32),
                            "b1": np.asarray(b1, f32),
                            "b2": np.asarray(b2, f32),
                            "eps": np.asarray(group["eps"], f32),
                            "eps_root": np.asarray(0.0, f32)},
            "hyperparams_states": {},
            "inner_state": {"0": {"count": np.asarray(count, np.int32),
                                  "mu": mu_tree, "nu": nu_tree},
                            "1": {}}}


def load_adam_state(optimizer, model, tree):
    """Load the tree of adam_state_tree (or one that the JAX trainer
    saved) into torch.optim.Adam over `model`'s parameters: step, exp_avg
    and exp_avg_sq per parameter; lr, betas and eps from the
    hyperparameters where they differ from the group's beyond f32
    rounding. Raises on a tree of other names or shapes."""
    named = _named_params(optimizer, model)
    inner = tree["inner_state"]["0"]
    mu, nu = from_jax(inner["mu"], {}), from_jax(inner["nu"], {})
    names = [n for n, _ in named]
    if sorted(mu) != sorted(names) or sorted(nu) != sorted(names):
        raise ValueError("the optimizer state's parameters differ from the "
                         "model's")
    step = float(np.asarray(inner["count"]))
    state = {}
    for i, (name, p) in enumerate(named):
        if mu[name].shape != p.shape or nu[name].shape != p.shape:
            raise ValueError(f"optimizer state of {name}: shape "
                             f"{tuple(mu[name].shape)}, parameter "
                             f"{tuple(p.shape)}")
        state[i] = {"step": torch.tensor(step, dtype=torch.float32),
                    "exp_avg": mu[name].to(p.dtype),
                    "exp_avg_sq": nu[name].to(p.dtype)}
    sd = optimizer.state_dict()
    group = dict(sd["param_groups"][0])
    hyper = tree.get("hyperparams", {})

    def pick(current, key):
        if key not in hyper:
            return current
        saved = float(np.asarray(hyper[key]))
        return current if np.float32(current) == np.float32(saved) else saved
    group["lr"] = pick(group["lr"], "learning_rate")
    group["betas"] = (pick(group["betas"][0], "b1"),
                      pick(group["betas"][1], "b2"))
    group["eps"] = pick(group["eps"], "eps")
    optimizer.load_state_dict({"state": state, "param_groups": [group]})

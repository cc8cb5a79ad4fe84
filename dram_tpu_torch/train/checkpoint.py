"""Checkpoints: flax msgpack trees with a tolerant, shape-checked restore.

Port of dram_tpu/train/checkpoint.py (`save_checkpoint` :20,
`load_checkpoint` :30, `newest_checkpoint` :35, `tolerant_merge` :58) in
the same format, flax msgpack of nested dicts of arrays, read and written
by the port's own codec (weights.msgpack_unpackb / msgpack_packb), so
that dram_tpu's checkpoints load in the port and the port's in dram_tpu.
Trees hold flax names and layouts: weights.to_jax maps a model's
state_dict into one, weights.load_into back.

`optimizer_state_tree` / `load_optimizer_state` map the port's optimizer
state to and from the tree that flax.serialization.to_state_dict makes
of the JAX trainer's optax state (its checkpoints' "optimizer" entry),
for each optimizer dram_tpu configures (dram_tpu/train/trainer.py:164-176,
326-358):

- Adam, `inject_hyperparams(adam)`: `count` (int32), `hyperparams`
  (learning_rate, b1, b2, eps, eps_root as f32 scalars),
  `hyperparams_states` {} and `inner_state` {"0": {count, mu, nu},
  "1": {}}, with mu and nu in the parameters' flax names and layouts;
- AdamW (Adam with weight_decay): hyperparams also hold weight_decay,
  inner_state {"0": {count, mu, nu}, "1": {}, "2": {}};
- SGD: hyperparams learning_rate (and momentum when it is non-zero),
  inner_state {"0": {"trace": ...}, "1": {}} with momentum, else
  {"0": {}, "1": {}};
- groups (optax.multi_transform): {"inner_states": {label:
  {"inner_state": the group's state}}}, each group's trees holding every
  parameter's name, with {} (optax's MaskedNode) for the parameters of
  other groups.

Torch's exp_avg, exp_avg_sq and momentum_buffer are optax's mu, nu and
trace; a group's "count" (trainer._with_counts) and Adam's per-parameter
step are optax's count.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from .. import weights
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


def _kind(optimizer, group):
    """The optax transform of one group: adam, adamw (Adam with a weight
    decay: dram_tpu builds optax's adamw for a group whose settings
    decay, adam otherwise) or sgd."""
    if isinstance(optimizer, torch.optim.SGD):
        return "sgd"
    if isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        return "adamw" if group.get("weight_decay") else "adam"
    raise ValueError(f"no optax layout for {type(optimizer).__name__}")


def _group_names(optimizer, model):
    """[(group, [(name, parameter), ...])] in the optimizer's group order:
    together the groups must hold exactly the model's parameters."""
    by_id = {id(p): n for n, p in model.named_parameters()}
    out, seen = [], set()
    for g in optimizer.param_groups:
        named = []
        for p in g["params"]:
            if id(p) not in by_id:
                raise ValueError("the optimizer holds a parameter that is "
                                 "not the model's")
            named.append((by_id[id(p)], p))
            seen.add(id(p))
        out.append((g, named))
    if len(seen) != len(by_id):
        raise ValueError("the optimizer's groups must hold every parameter "
                         "of the model")
    if len(out) > 1 and any("label" not in g for g in optimizer.param_groups):
        raise ValueError("optimizer groups need their 'label'")
    return out


def _masked_tree(values, names_all, params):
    """Flax-named tree of `values` ({name: tensor}) over every name of
    `names_all`, {} where a name has no value (a masked parameter)."""
    tree = to_jax(values)[0]
    for name in names_all:
        if name in values:
            continue
        node = tree
        *mods, leaf = weights.flax_path(name, params[name].dim())
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = {}
    return tree


def _count(group, named, optimizer):
    if "count" in group:
        return int(group["count"])
    for _, p in named:
        st = optimizer.state.get(p) or {}
        if "step" in st:
            return int(st["step"])
    return 0


def _state_of(kind, optimizer, group, named, names_all, params):
    """The optax state of one group (an inject_hyperparams state)."""
    f32 = np.float32
    count = np.asarray(_count(group, named, optimizer), np.int32)
    hyper = {"learning_rate": np.asarray(group["lr"], f32)}
    if kind in ("adam", "adamw"):
        mu, nu = {}, {}
        for name, p in named:
            st = optimizer.state.get(p) or {}
            mu[name] = st.get("exp_avg", torch.zeros_like(p))
            nu[name] = st.get("exp_avg_sq", torch.zeros_like(p))
        b1, b2 = group["betas"]
        hyper.update(b1=np.asarray(b1, f32), b2=np.asarray(b2, f32),
                     eps=np.asarray(group["eps"], f32),
                     eps_root=np.asarray(0.0, f32))
        inner = {"0": {"count": count,
                       "mu": _masked_tree(mu, names_all, params),
                       "nu": _masked_tree(nu, names_all, params)},
                 "1": {}}
        if kind == "adamw":
            hyper["weight_decay"] = np.asarray(group["weight_decay"], f32)
            inner["2"] = {}
    elif group["momentum"]:
        trace = {}
        for name, p in named:
            st = optimizer.state.get(p) or {}
            buf = st.get("momentum_buffer")
            trace[name] = torch.zeros_like(p) if buf is None else buf
        hyper["momentum"] = np.asarray(group["momentum"], f32)
        inner = {"0": {"trace": _masked_tree(trace, names_all, params)},
                 "1": {}}
    else:
        inner = {"0": {}, "1": {}}
    return {"count": count, "hyperparams": hyper, "hyperparams_states": {},
            "inner_state": inner}


def optimizer_state_tree(optimizer, model):
    """The port's optimizer state over `model`'s parameters -> the flax
    state dict of dram_tpu's optax state for the same OPTIMIZER
    (numpy)."""
    groups = _group_names(optimizer, model)
    params = dict(model.named_parameters())
    names_all = list(params)
    if len(groups) == 1 and "label" not in groups[0][0]:
        g, named = groups[0]
        return _state_of(_kind(optimizer, g), optimizer, g, named,
                         names_all, params)
    return {"inner_states": {
        g["label"]: {"inner_state": _state_of(_kind(optimizer, g), optimizer,
                                              g, named, names_all, params)}
        for g, named in groups}}


def _unmasked(tree):
    """A flax-named tree without its {} leaves (masked parameters)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            if v:
                sub = _unmasked(v)
                if sub:
                    out[k] = sub
        else:
            out[k] = v
    return out


def _load_group(kind, group, named, st, state_by_index, index_of):
    """Load one group's optax state `st` into the per-parameter states
    (keyed by the optimizer's parameter index) and the group dict."""
    inner = st["inner_state"]
    names = [n for n, _ in named]
    count = float(np.asarray(st.get("count", 0)))
    if kind in ("adam", "adamw"):
        mu = from_jax(_unmasked(inner["0"]["mu"]), {})
        nu = from_jax(_unmasked(inner["0"]["nu"]), {})
        if sorted(mu) != sorted(names) or sorted(nu) != sorted(names):
            raise ValueError("the optimizer state's parameters differ from "
                             "the model's")
        count = float(np.asarray(inner["0"]["count"]))
        for name, p in named:
            if mu[name].shape != p.shape or nu[name].shape != p.shape:
                raise ValueError(f"optimizer state of {name}: shape "
                                 f"{tuple(mu[name].shape)}, parameter "
                                 f"{tuple(p.shape)}")
            state_by_index[index_of[id(p)]] = {
                "step": torch.tensor(count, dtype=torch.float32),
                "exp_avg": mu[name].to(p.dtype),
                "exp_avg_sq": nu[name].to(p.dtype)}
    elif "trace" in inner.get("0", {}):
        trace = from_jax(_unmasked(inner["0"]["trace"]), {})
        if sorted(trace) != sorted(names):
            raise ValueError("the optimizer state's parameters differ from "
                             "the model's")
        for name, p in named:
            if trace[name].shape != p.shape:
                raise ValueError(f"optimizer state of {name}: shape "
                                 f"{tuple(trace[name].shape)}, parameter "
                                 f"{tuple(p.shape)}")
            state_by_index[index_of[id(p)]] = {
                "momentum_buffer": trace[name].to(p.dtype)}
    group["count"] = int(count)
    hyper = st.get("hyperparams", {})

    def pick(current, key):
        if key not in hyper:
            return current
        saved = float(np.asarray(hyper[key]))
        return current if np.float32(current) == np.float32(saved) else saved
    group["lr"] = pick(group["lr"], "learning_rate")
    if kind in ("adam", "adamw"):
        group["betas"] = (pick(group["betas"][0], "b1"),
                          pick(group["betas"][1], "b2"))
        group["eps"] = pick(group["eps"], "eps")
        if kind == "adamw":
            group["weight_decay"] = pick(group["weight_decay"],
                                         "weight_decay")
    elif "momentum" in hyper:
        group["momentum"] = pick(group["momentum"], "momentum")


def load_optimizer_state(optimizer, model, tree):
    """Load the tree of optimizer_state_tree (or one that the JAX trainer
    saved for the same OPTIMIZER) into the port's optimizer over
    `model`'s parameters: the per-parameter moments or traces, the
    counts, and lr, betas, eps, weight decay and momentum from the
    hyperparameters where they differ from the group's beyond f32
    rounding. Raises on a tree of other names, shapes or groups."""
    groups = _group_names(optimizer, model)
    sd = optimizer.state_dict()
    new_groups = [dict(g) for g in sd["param_groups"]]
    index_of, i = {}, 0
    for g in optimizer.param_groups:
        for p in g["params"]:
            index_of[id(p)] = i
            i += 1
    state = {}
    if "inner_states" in tree:
        saved = tree["inner_states"]
        labels = [g.get("label") for g, _ in groups]
        if sorted(saved) != sorted(labels):
            raise ValueError(f"the checkpoint's optimizer groups "
                             f"{sorted(saved)} differ from {sorted(labels)}")
        for ng, (g, named) in zip(new_groups, groups):
            _load_group(_kind(optimizer, g), ng, named,
                        saved[g["label"]]["inner_state"], state, index_of)
    else:
        if len(groups) != 1:
            raise ValueError("the checkpoint holds one optimizer state, the "
                             "optimizer has groups")
        _load_group(_kind(optimizer, groups[0][0]), new_groups[0],
                    groups[0][1], tree, state, index_of)
    optimizer.load_state_dict({"state": state, "param_groups": new_groups})

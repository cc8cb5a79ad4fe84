"""Reference PyTorch `.pth` checkpoints into the port.

Port of dram_tpu/train/torch_import.py (:65-202). The reference training
saves torch state dicts of its DC3D / DC3DATGeneric module tree
(`{"epoch", "iteration", "model", "optimizer", "metrics"}`);
`convert_state_dict` maps one onto the flax-named numpy tree that the
port's checkpoints hold (weights.load_into then loads it into a model,
weights.from_jax gives its state_dict):

  ds_modules.{i}.conv_blocks.{j}.0.{weight,bias}  -> ds_{i}/convs/conv_{j}
  ds_modules.{i}.conv_blocks.{j}.1.weight         -> .../BatchNorm_{j}/scale
  ds_modules.{i}.conv_blocks.{j}.1.bias           -> .../BatchNorm_{j}/bias
  ds_modules.{i}.conv_blocks.{j}.1.running_mean   -> batch_stats .../mean
  ds_modules.{i}.conv_blocks.{j}.1.running_var    -> batch_stats .../var
  bg.conv_blocks...                               -> bg/convs/...
  us_modules.{i}.conv_blocks...                   -> us_{i}/convs/...
  top_layer.{weight,bias}                         -> top_layer/{kernel,bias}
  reshape.{i}.0.{weight,bias}                     -> reshape_{i}/conv/...
  reshape.{i}.1.*                                 -> reshape_{i}/bn/...
  attention_module.{theta,phi,G,r,geo_*}.{weight,bias}
                                                  -> attention_module/...

Conv3d weights (Co, Ci, kd, kh, kw) become flax kernels (kd, kh, kw, Ci,
Co), Linear weights (out, in) Dense kernels (in, out);
`num_batches_tracked` and the reference's `dummy` scalar are dropped;
a DC3DATGeneric's backbone keys land under `backbone/`.
`load_torch_checkpoint` reads a `.pth` (the training save dict or a bare
state dict) into the checkpoint layout and `import_torch_checkpoint`
writes it as a `.ckpt` that RELOAD_CHECKPOINT_PATH loads.
"""

from __future__ import annotations

import numpy as np
import torch

from .checkpoint import save_checkpoint

# PCM projection heads: same attribute names on both sides
# (reference models.py:169-191 <-> dram_tpu/models/pcm.py).
_PCM_LINEARS = ("theta", "phi", "G", "r", "geo_theta", "geo_phi")
# Keys that mark a DC3DATGeneric checkpoint (reference models.py:488-495).
_AT_PREFIXES = ("reshape.", "attention_module.")


def _conv_kernel(w):
    """torch Conv3d (Co,Ci,kd,kh,kw) -> flax (kd,kh,kw,Ci,Co)."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 4, 1, 0)))


def _set(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _np(v):
    if hasattr(v, "detach"):  # torch tensor
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def convert_state_dict(sd, log=None):
    """Reference model state dict -> (params, batch_stats) nested dicts.

    Returns plain dict-of-ndarray trees in this package's naming; keys the
    mapper does not recognize are skipped with a log line, mirroring the
    reference loader's tolerance (job_runner.py:252-288).
    """
    log = log or (lambda *_: None)
    is_at = any(k.startswith(_AT_PREFIXES) for k in sd)
    params, stats = {}, {}
    skipped = []

    def backbone(path):
        return (("backbone",) + path) if is_at else path

    for key, raw in sd.items():
        parts = key.split(".")
        head = parts[0]
        if head == "dummy" or parts[-1] == "num_batches_tracked":
            continue
        v = _np(raw)
        if head in ("ds_modules", "us_modules") and len(parts) == 6 and \
                parts[2] == "conv_blocks":
            flax_mod = ("ds_" if head == "ds_modules" else "us_") + parts[1]
            base = backbone((flax_mod,))
            _stack_put(params, stats, base, parts[3], parts[4], parts[5],
                       v, key, skipped)
        elif head == "bg" and len(parts) == 5 and parts[1] == "conv_blocks":
            _stack_put(params, stats, backbone(("bg",)), parts[2], parts[3],
                       parts[4], v, key, skipped)
        elif head == "top_layer" and len(parts) == 2:
            if parts[1] == "weight":
                _set(params, backbone(("top_layer", "kernel")),
                     _conv_kernel(v))
            elif parts[1] == "bias":
                _set(params, backbone(("top_layer", "bias")), v)
            else:
                skipped.append(key)
        elif head == "reshape" and len(parts) == 4:
            i, lidx, leaf = parts[1], parts[2], parts[3]
            if lidx == "0":  # 1x1x1 Conv3d tap head
                if leaf == "weight":
                    _set(params, (f"reshape_{i}", "conv", "kernel"),
                         _conv_kernel(v))
                elif leaf == "bias":
                    _set(params, (f"reshape_{i}", "conv", "bias"), v)
                else:
                    skipped.append(key)
            elif lidx == "1":  # BatchNorm3d
                if leaf == "weight":
                    _set(params, (f"reshape_{i}", "bn", "scale"), v)
                elif leaf == "bias":
                    _set(params, (f"reshape_{i}", "bn", "bias"), v)
                elif leaf == "running_mean":
                    _set(stats, (f"reshape_{i}", "bn", "mean"), v)
                elif leaf == "running_var":
                    _set(stats, (f"reshape_{i}", "bn", "var"), v)
                else:
                    skipped.append(key)
            else:
                skipped.append(key)
        elif head == "attention_module" and len(parts) == 3 and \
                parts[1] in _PCM_LINEARS:
            if parts[2] == "weight":  # Linear (out,in) -> Dense (in,out)
                _set(params, ("attention_module", parts[1], "kernel"),
                     np.ascontiguousarray(v.T))
            elif parts[2] == "bias":
                _set(params, ("attention_module", parts[1], "bias"), v)
            else:
                skipped.append(key)
        else:
            skipped.append(key)

    for k in skipped:
        log(f"torch-import: no flax counterpart for '{k}', skipped")
    return params, stats


def _stack_put(params, stats, base, j, lidx, leaf, v, key, skipped):
    """Place one conv_blocks.{j}.{0|1}.{leaf} tensor."""
    if lidx == "0":  # Conv3d
        if leaf == "weight":
            _set(params, base + ("convs", f"conv_{j}", "kernel"),
                 _conv_kernel(v))
        elif leaf == "bias":
            _set(params, base + ("convs", f"conv_{j}", "bias"), v)
        else:
            skipped.append(key)
    elif lidx == "1":  # BatchNorm3d
        bn = base + ("convs", f"BatchNorm_{j}")
        if leaf == "weight":
            _set(params, bn + ("scale",), v)
        elif leaf == "bias":
            _set(params, bn + ("bias",), v)
        elif leaf == "running_mean":
            _set(stats, bn + ("mean",), v)
        elif leaf == "running_var":
            _set(stats, bn + ("var",), v)
        else:
            skipped.append(key)
    else:
        skipped.append(key)


def load_torch_checkpoint(path, log=None):
    """Read a reference ``.pth`` -> {"model": {"params", "batch_stats"},
    "epoch", "iteration"} in this package's checkpoint layout.

    Accepts either the full training save dict (``{"model": sd, ...}``,
    job_runner.py:707-716) or a bare model state dict.
    """
    try:
        saved = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        saved = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(saved, dict) and "model" in saved and \
            not any("." in k for k in saved):
        sd = saved["model"]
        epoch = int(saved.get("epoch", 0))
        iteration = int(saved.get("iteration", 0))
    else:
        sd, epoch, iteration = saved, 0, 0
    params, stats = convert_state_dict(sd, log=log)
    return {"epoch": epoch, "iteration": iteration,
            "model": {"params": params, "batch_stats": stats}}


def import_torch_checkpoint(pth_path, ckpt_path, log=None):
    """``.pth`` file -> repo ``.ckpt`` (msgpack) the trainer/engine can
    reload via RELOAD_CHECKPOINT_PATH (tolerant_merge shape-checks every
    leaf on load, exactly like the reference loader)."""
    state = load_torch_checkpoint(pth_path, log=log)
    save_checkpoint(ckpt_path, state)
    return state

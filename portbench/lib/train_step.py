"""Driver of the "train_step" traffic kind: the port's training step
(`TrainStep`, timed=False) back to back over `n_batches` distinct
batches, cycled.

Set-up builds one TrainStep (model, Adam, loss from the configuration),
puts the harness's parameters from the seed into it, makes the batches
on the device from the seed (lib/synth.py) and hands them to the port's
feed (`batch_tensors`, the u16 image wire), then takes the first
`checked_steps` steps through the window's own call: their losses, the
first gradient as Adam holds it (exp_avg / (1 - beta1) after one step)
and the state after the last of them are kept for the check. The window
goes on with the same object; each step's loss is read a step late, as
the epoch loop reads it. Checks (after the window, with the program's
state freed): the reference's steps from the same parameters on the
same batches."""

import time

import numpy as np
import torch

from . import build, harness, synth
from ..reference import train as ref_train

# leaves whose reference gradient is under this share of the median
# leaf's move under Adam by round-off alone: out of change_gap and
# grad_cos_gap
STILL_LEAF = 1e-3


def make_batches(seed, cfg, traffic, device):
    v = cfg["values"]
    return [synth.train_batch((int(seed) * 16 + j + 1) % 2 ** 63,
                              int(v["TRAIN_BATCH_SIZE"]),
                              int(v["RESAMPLE_SIZE"][0]),
                              (v["WINDOWING_MIN"], v["WINDOWING_MAX"]),
                              device)
            for j in range(int(traffic["n_batches"]))]


def feed(batch, device, wire, rows=None):
    """A harness batch through the port's feed (collated numpy, then
    batch_tensors' packing onto the device)."""
    from dram_tpu_torch.train.trainer import batch_tensors
    sl = slice(None) if rows is None else slice(0, rows)
    ctss = batch["ctss"][sl].cpu().numpy()
    counts = np.bincount(ctss, minlength=6) / float(len(ctss))
    collated = {"#image": batch["image"][sl].cpu().numpy(),
                "#lobe_reference": batch["lobe"][sl].cpu().numpy(),
                "#lesion_reference": batch["lesion"][sl].cpu().numpy(),
                "meta": {"ctss": [int(c) for c in ctss]},
                "ctss_frequency": batch["freq"].cpu().numpy()
                if rows is None else
                np.where(counts > 0, counts, 1e-5).astype(np.float32)}
    return batch_tensors(collated, device, wire)


def run(cfg, traffic, seed, seconds, trace, device, fault=None,
        profiled=None, on_setup_done=None):
    phase = harness.Phases()
    from dram_tpu_torch.train.trainer import build_train_step
    phase("port imported")
    s = build.settings(cfg)
    step = build_train_step(s, device)
    phase("train step built")
    model = step.model
    shapes = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    state0 = build.seeded_state(shapes, seed, device)
    model.load_state_dict(state0, strict=True)
    wire = str(cfg["values"].get("TRAIN_WIRE", "u16"))
    batches = make_batches(seed, cfg, traffic, device)
    rows = None
    if fault == "half_batch":
        rows = int(cfg["values"]["TRAIN_BATCH_SIZE"]) // 2
    feeds = [feed(b, device, wire, rows) for b in batches]
    phase("batches")
    if fault == "state_unchanged":
        step.optimizer.step = lambda *a, **k: None
    ranges = None
    if trace and profiled is not None and hasattr(model, "attention_module"):
        from .profiling import PCM_TAPS
        from .trace import Ranges
        ranges = Ranges([model.attention_module] + list(
            model.reshape_heads), PCM_TAPS)

    names = [k for k, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    beta1 = float(step.optimizer.param_groups[0]["betas"][0])
    losses, grads = [], None
    n_checked = int(traffic["checked_steps"])
    for t in range(n_checked):
        r = step(**feeds[t % len(feeds)], timed=False)
        losses.append(float(r["loss"]))
        if t == 0:
            # Adam's first moment after one step is (1 - beta1) g; a
            # step that left the optimizer's state as it was holds none
            grads = {}
            for k in names:
                m = step.optimizer.state[params[k]].get("exp_avg")
                m = torch.zeros_like(params[k]) if m is None else m
                grads[k] = (m / (1.0 - beta1)).float().to("cpu", copy=True)
    state3 = {k: t.detach().float().to("cpu", copy=True)
              for k, t in model.state_dict().items()}
    if profiled is not None:
        profiled.warm()
    phase("checked steps")
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    if on_setup_done is not None:
        on_setup_done()

    done, window_losses, window_s = _window(
        step, feeds, n_checked, seconds, profiled, traffic, device)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    if ranges is not None:
        ranges.remove()
    del step, model, params, feeds
    if device.type == "cuda":
        torch.cuda.empty_cache()
    phase("window")
    prog = {"loss": losses, "grads": grads, "state": state3}
    numbers = check(prog, state0, batches, cfg, n_checked)
    phase("reference check")
    bad = sum(1 for x in window_losses if not np.isfinite(x))
    return {"window": {"done": done, "attempted": done,
                       "window_s": window_s,
                       "chunks": done * int(cfg["values"]["TRAIN_BATCH_SIZE"])},
            "numbers": numbers, "per_unit": [], "window_bad": bad,
            "attempted": done, "peak_bytes": peak}


def _window(step, feeds, k, seconds, profiled, traffic, device):
    """Steps back to back for `seconds`, each loss read a step late;
    with `profiled`, `profile_steps` of them profiled after
    `profile_after_s`. Returns (steps, losses, seconds)."""
    done, losses, prev = 0, [], None
    prof_state, first = 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if profiled is not None and prof_state == 0 and \
                time.perf_counter() - t0 >= float(traffic["profile_after_s"]):
            if prev is not None:
                losses.append(float(prev))
                prev = None
            profiled.start()
            prof_state, first = 1, done
        r = step(**feeds[k % len(feeds)], timed=False)
        k += 1
        done += 1
        if prev is not None:
            losses.append(float(prev))
        prev = r["loss"]
        if prof_state == 1 and done - first >= int(traffic["profile_steps"]):
            losses.append(float(prev))
            prev = None
            profiled.stop(done - first)
            prof_state = 2
    if prev is not None:
        losses.append(float(prev))
    if device.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    if prof_state == 1:
        profiled.stop(done - first)
    return done, losses, window_s


def compare(prog, ref, state0):
    """loss_gap: the worst step's |loss - reference| / |reference|.
    grad_gap: of the first gradients, the worst leaf's gap between the
    two norms over the larger of the reference's norm of that leaf and
    of the median leaf. change_gap: the same of the change from the
    start after the checked steps, over the parameters and BatchNorm's
    running statistics. grad_cos_gap: the median leaf's 1 - cosine
    between the two first gradients (a norm moves by the square of a
    rounding error orthogonal to the gradient, the direction by the
    error itself: this number separates the fp8 control, the norms do
    not). Leaves whose reference gradient is under STILL_LEAF of the
    median leaf's are left out of change_gap and grad_cos_gap."""
    lg = max(abs(a - b) / max(abs(b), 1e-30)
             for a, b in zip(prog["loss"], ref["loss"]))
    gp = {k: float(v.double().norm()) for k, v in prog["grads"].items()}
    gr = {k: float(v.double().norm()) for k, v in ref["grads"].items()}
    if set(gp) != set(gr):
        return {"loss_gap": lg, "grad_gap": float("inf"),
                "grad_cos_gap": float("inf"), "change_gap": float("inf")}
    med = float(np.median(list(gr.values())))
    gg = max(abs(gp[k] - gr[k]) / max(gr[k], med, 1e-30) for k in gr)
    keep = [k for k in state0 if k not in gr or gr[k] >= STILL_LEAF * med]
    cos = [float(torch.nn.functional.cosine_similarity(
        prog["grads"][k].double().flatten(), ref["grads"][k].double()
        .flatten(), dim=0)) for k in gr if k in keep]
    gc_gap = float(np.median([1.0 - c for c in cos]))
    dp = {k: float((prog["state"][k].double().cpu()
                    - state0[k].double().cpu()).norm()) for k in keep}
    dr = {k: float((ref["state"][k].double().cpu()
                    - state0[k].double().cpu()).norm()) for k in keep}
    medd = float(np.median(list(dr.values())))
    cg = max(abs(dp[k] - dr[k]) / max(dr[k], medd, 1e-30) for k in keep)
    return {"loss_gap": lg, "grad_gap": gg, "grad_cos_gap": gc_gap,
            "change_gap": cg}


def check(prog, state0, batches, cfg, n_steps):
    ref = ref_train.steps(state0, batches, cfg["values"], n_steps)
    ref["grads"] = {k: v.cpu() for k, v in ref["grads"].items()}
    return compare(prog, ref, state0)

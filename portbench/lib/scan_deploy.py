"""Driver of the "scan_deploy" traffic kind: the inference engine's fast
path, `LesionSegTest.process_scan_fast`, one scan after another in a
closed loop, as the engine has it: the C++ prep in line.

Set-up: the engine (dram_tpu_torch.infer.engine) on the configuration's
settings and the traffic's `engine` settings (logging to standard
error, its paths inside portbench/.cache/deploy, an empty checkpoint),
holding the harness's weights; one synthetic scan of each of the mix's
geometries from the seed (scan_infer.make_scans), in host memory; one
pass of each through process_scan_fast. Window: the scans cycled in an
order drawn from the seed, each through process_scan_fast: the C++ prep
(`prep_scan_chunks`) on the chunk wire, the model, the back-gather to
the scan grid, the post rule and the lobe labels, returned on the host;
screenshots and file writes are not part of it. The lobe ratios the
labels come from, and the host time of the device pipeline, are read
where the engine's pipeline returns them (`process_chunks`, wrapped on
the engine's own pipeline). A scan's latency runs from the call to its
return. Checks (after the window, with the program's state freed):
every `check_every`-th answer (the last one in a window too short for
any) against the reference's answer for its scan, put on the scan grid
(reference/scan_grid.py)."""

import os
import time

import numpy as np
import torch

from . import build, flaxckpt, harness, scan_infer
from ..reference import scan as ref_scan
from ..reference import scan_grid

FAMILY = "scan"
KEYS = ("pred_diff", "post_diff", "ratio_gap", "label_err")
CACHE = os.path.join(harness.PORTBENCH, ".cache", "deploy")


def tap_ratios(eng):
    """A list that receives (ratios, present, host seconds) of each scan's
    call of the engine's pipeline from process_scan_fast, which keeps
    only the labels of the ratios."""
    pipe = eng._fast()
    chunks = pipe.process_chunks
    seen = []

    def recorded(prepc, *args, **kw):
        t0 = time.perf_counter()
        res = chunks(prepc, *args, **kw)
        seen.append((np.asarray(res["ratios"], np.float64),
                     np.asarray(res["present"]), time.perf_counter() - t0))
        return res
    pipe.process_chunks = recorded
    return seen


def engine(cfg, traffic, seed, device):
    """(the engine on the configuration and the traffic's settings, the
    state it holds: the checkpoint the configuration names under
    "weights", or build.seeded_state when it says "seed")."""
    from dram_tpu_torch.infer.engine import LesionSegTest
    from dram_tpu_torch.train.checkpoint import save_checkpoint
    scans = os.path.join(CACHE, "scans")
    os.makedirs(scans, exist_ok=True)
    ckpt = os.path.join(CACHE, "empty.ckpt")
    save_checkpoint(ckpt, {})
    s = build.settings(cfg)
    values = dict(traffic["engine"],
                  TEST_RESAMPLE_SPACING=float(traffic["iso_spacing"]),
                  PAD_VALUE=traffic["pad_value"],
                  MODEL_ROOT_PATH=os.path.join(CACHE, "models"),
                  DEBUG_PATH=os.path.join(CACHE, "debug"),
                  RELOAD_CHECKPOINT_PATH=ckpt, RELOAD_DICT_LIST=[],
                  LOGGING=None)
    for k, v in values.items():
        setattr(s, k, v)
    eng = LesionSegTest(s, scan_path=scans, lobe_path=scans,
                        output_path=CACHE, device=device, devices=[device])
    shapes = {k: tuple(v.shape) for k, v in eng.model.state_dict().items()}
    if cfg["weights"] == "seed":
        state = build.seeded_state(shapes, seed, device)
    else:
        sd = flaxckpt.state_dict_np(os.path.join(harness.ROOT,
                                                 cfg["weights"]))
        state = {k: torch.from_numpy(sd[k]).to(device) for k in shapes}
    eng.model.load_state_dict(state, strict=True)
    return eng, state


def run(cfg, traffic, seed, seconds, trace, device, fault=None,
        profiled=None, on_setup_done=None):
    phase = harness.Phases()
    eng, state = engine(cfg, traffic, seed, device)
    phase("port imported, engine and weights")
    if fault == "half_batch":
        n = len(traffic["lesion_severity"])
        drop = list(range(n - n // 2, n))
        stage = eng.model.forward

        def half(x):
            keep = torch.ones(x.shape[0], 1, 1, 1, 1, dtype=x.dtype,
                              device=x.device)
            keep[drop] = 0
            return stage(x * keep)
        eng.model.forward = half
    scans = scan_infer.make_scans(seed, traffic, device)
    data = [{"#image": s, "#lobe_reference": lb, "meta": {"spacing": sp}}
            for s, lb, sp in scans]
    phase("scans")
    rng = np.random.default_rng(int(seed) % 2 ** 63)
    order = [int(i) for i in rng.permutation(len(scans))]
    every = int(traffic["check_every"])
    sample = (every, int(rng.integers(every)))
    seen = tap_ratios(eng)
    for d in data:
        eng.process_scan_fast(d)
    if profiled is not None:
        profiled.warm()
    phase("warm-up")
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    if on_setup_done is not None:
        on_setup_done()
    window, answers = _window(
        eng, data, order, seen, seconds, sample, fault, profiled,
        float(traffic["profile_after_s"]) if trace else 0.0,
        int(traffic["profile_scans"]))
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    phase("window")
    del eng
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, per_answer = check(answers, scans, state, cfg, traffic, device)
    phase("reference check")
    return {"window": window, "numbers": numbers, "per_unit": per_answer,
            "attempted": window["attempted"], "peak_bytes": peak}


def _window(eng, data, order, seen, seconds, sample, fault, profiled,
            profile_after, profile_scans):
    """Scans through process_scan_fast for `seconds`. Returns (the
    window's record, the answers kept for the check). Each scan's
    seconds in the engine's prep (its own `ms["prep"]`) and in the
    engine's work around prep and pipeline (the call less both) are
    kept for the per-layer readers."""
    every, first = sample
    answers, latencies, prep_s, engine_s = [], [], [], []
    prof_state, done, k = 0, 0, 0
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        if profiled is not None and prof_state == 0 and \
                time.perf_counter() - t_start >= profile_after:
            profiled.start()
            prof_state, first_prof = 1, done
        i = order[k % len(order)]
        k += 1
        seen.clear()
        t0 = time.perf_counter()
        out = eng.process_scan_fast(data[i])
        t1 = time.perf_counter()
        if len(seen) != 1:
            raise RuntimeError("process_scan_fast ran its pipeline "
                               f"{len(seen)} times")
        ratios, present, pipe_s = seen[0]
        answer = (i, {"pred": out["pred"], "post": out["post"],
                      "labels": out["cls_preds"], "ratios": ratios,
                      "present": present})
        if fault == "alter_answer":
            pred = answer[1]["pred"] = out["pred"].copy()
            pred.reshape(-1)[: max(1, pred.size // 20)] ^= 1
            answer[1]["labels"] = [(c + 1) % 6 for c in out["cls_preds"]]
        if done % every == first:
            answers.append(answer)
        latencies.append(t1 - t0)
        prep_s.append(out["ms"]["prep"] / 1e3)
        engine_s.append(t1 - t0 - prep_s[-1] - pipe_s)
        done += 1
        if prof_state == 1 and done - first_prof >= profile_scans:
            profiled.stop(done - first_prof)
            prof_state = 2
    window_s = time.perf_counter() - t_start
    if prof_state == 1:
        profiled.stop(done - first_prof)
    if done and not answers:
        answers.append(answer)
    return {"done": done, "attempted": k, "window_s": window_s,
            "latencies_s": latencies, "prep_s": prep_s,
            "engine_s": engine_s}, answers


def reference_answer(scan, state, cfg, traffic, device, quant="exact",
                     drop_lobes=()):
    """The reference's answer for one scan of make_scans on the scan
    grid: {"pred", "post" (device bool), "ratios", "labels",
    "present"}."""
    img, lobe, spacing = scan
    r = ref_scan.run_scan(torch.from_numpy(img).to(device),
                          torch.from_numpy(lobe).to(device), spacing, state,
                          cfg["values"], traffic, quant, drop_lobes)
    iso = float(traffic["iso_spacing"])
    out = {k: scan_grid.on_scan_grid(r[k], img.shape, spacing, iso)
           for k in ("pred", "post")}
    out.update(ratios=np.asarray(r["ratios"], np.float64),
               labels=scan_grid.labels(r["ratios"]),
               present=np.ones(len(r["ratios"])))
    return out


def gaps(mine, ref):
    """The numbers of one answer ({"pred", "post": u8 or bool on the
    scan grid, "labels" of the present lobes, "ratios", "present"})
    against the reference's: pred_diff and post_diff, the voxels where
    the masks before and after the post rule differ over the
    reference's mask voxels; ratio_gap, the largest gap between a lobe's
    predicted lesion ratio and the reference's; label_err, the present
    lobes whose label is not the class of the answer's own ratio by the
    reference's table (scan_grid.labels), an exact comparison."""
    out = {}
    for k in ("pred", "post"):
        m = torch.as_tensor(mine[k]).to(ref[k].device).bool()
        out[f"{k}_diff"] = float((m ^ ref[k]).sum()) \
            / max(float(ref[k].sum()), 1.0)
    r = np.asarray(mine["ratios"], np.float64)
    out["ratio_gap"] = float(np.max(np.abs(r - ref["ratios"]))) \
        if r.shape == ref["ratios"].shape else float("inf")
    want = scan_grid.labels(r[np.asarray(mine["present"]) >= 1])
    out["label_err"] = float(
        sum(a != b for a, b in zip(mine["labels"], want))
        + abs(len(mine["labels"]) - len(want)))
    return out


def worst(per_answer):
    """The largest of each number over the answers (inf without any)."""
    return {k: max((a[k] for a in per_answer), default=float("inf"))
            for k in KEYS}


def check(answers, scans, state, cfg, traffic, device):
    """The worst numbers over the answers kept from the window (every
    `check_every`-th from an offset drawn from the seed), and each
    answer's numbers; the reference runs once for each scan sampled."""
    refs = {i: reference_answer(scans[i], state, cfg, traffic, device)
            for i in sorted({i for i, _ in answers})}
    per_answer = [gaps(mine, refs[i]) for i, mine in answers]
    return worst(per_answer), per_answer


def readings(cfg, traffic, seed, device):
    """{what: numbers} of the control (the reference in fp8) and of half
    of each scan's chunks left out, each the worst over the mix's scans
    against the exact reference, by the comparison that decides a run
    (calibrate.py)."""
    _, state = build.model_and_state(cfg, seed, device)
    scans = scan_infer.make_scans(seed, traffic, device)
    n = len(traffic["lesion_severity"])
    refs = [reference_answer(s, state, cfg, traffic, device) for s in scans]
    out = {}
    for what, kw in (("control_fp8", {"quant": "fp8"}),
                     ("fault_half_batch",
                      {"drop_lobes": tuple(range(n - n // 2, n))})):
        out[what] = worst([gaps(reference_answer(s, state, cfg, traffic,
                                                 device, **kw), r)
                           for s, r in zip(scans, refs)])
    return out

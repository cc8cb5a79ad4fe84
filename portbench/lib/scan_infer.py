"""Driver of the "scan_infer" traffic kind: full-scan inference on the
chunk wire, a closed loop with `in_flight` scans outstanding.

Set-up: the model and its weights; one synthetic scan of each of the
mix's geometries from the seed (lib/synth.py), each prepared by the
port's C++ prep (`prep_scan_chunks`) into pinned host memory; one warm
pass of each. Window: the scans cycled in an order drawn from the seed
through `FastScanPipeline.process_chunks(prep, unpack=False)`, each
outstanding scan on a CUDA stream of its own (the call's host copies
wait for their own stream only, so the card runs one scan while the
host dispatches the next). A scan is done when its packed iso-grid
pred is on the host with post = pred AND candidate applied on the
packed rows; its latency runs from its dispatch to then. Checks (after
the window, with the program's state freed): every `check_every`-th
answer of the window against the reference's answer for its scan."""

import collections
import contextlib
import time

import numpy as np
import torch

from . import build, harness, synth
from ..reference import scan as ref_scan


def _scan_seed(seed, i):
    return (int(seed) * 16 + i + 1) % 2 ** 63


def _pinned(a):
    if not torch.cuda.is_available():
        return a
    t = torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
    return t.numpy()


def make_scans(seed, traffic, device):
    """[(scan int16 numpy, lobe u8 numpy, spacing)] of the mix."""
    out = []
    for i, (shape, spacing) in enumerate(traffic["geometries"]):
        s, l = synth.synth_scan(_scan_seed(seed, i), tuple(shape),
                                traffic["lesion_severity"], device)
        out.append((s.cpu().numpy(), l.cpu().numpy(), tuple(spacing)))
    return out


def prep(scans, cfg, traffic):
    from dram_tpu_torch.infer.fast import prep_scan_chunks
    v = cfg["values"]
    preps = []
    for scan, lobe, spacing in scans:
        p = prep_scan_chunks(
            scan, lobe, spacing, iso_spacing=float(traffic["iso_spacing"]),
            pad_value=traffic["pad_value"],
            windowing_span=(v["WINDOWING_MIN"], v["WINDOWING_MAX"]),
            chunk_size=tuple(v["RESAMPLE_SIZE"]),
            crop_border_mm=float(traffic["crop_border_mm"]))
        for k in ("x80_bits", "lobe_bits", "cand_bits"):
            p[k] = _pinned(p[k])
        preps.append(p)
    return preps


class Loop:
    """The closed loop over the prepared scans."""

    def __init__(self, pipe, preps, order, in_flight, device, sample,
                 fault=None):
        self.pipe, self.preps, self.order = pipe, preps, order
        self.in_flight = in_flight
        self.cuda = device.type == "cuda"
        self.streams = [torch.cuda.Stream() if self.cuda else None
                        for _ in range(in_flight)]
        self.sample = sample  # (every, first): answers kept for the check
        self.fault = fault
        self.k = 0
        self.answers = []
        self.latencies = []

    def _ctx(self, s):
        return torch.cuda.stream(s) if s is not None \
            else contextlib.nullcontext()

    def dispatch(self):
        i = self.order[self.k % len(self.order)]
        s = self.streams[self.k % self.in_flight]
        self.k += 1
        t0 = time.perf_counter()
        with self._ctx(s):
            res = self.pipe.process_chunks(self.preps[i], unpack=False)
        return i, t0, s, res

    def collect(self, item, record=True):
        i, t0, s, res = item
        with self._ctx(s):
            pred = res["pred_packed"].cpu().numpy()
            ratios = res["ratios"].float().cpu().numpy()
        if self.fault == "alter_answer":
            pred = pred.copy()
            pred[: max(1, pred.size // 20)] ^= 0xFF
        # post = pred AND candidate: the scan's answer on the host
        post = np.bitwise_and(pred, self.preps[i]["cand_bits"])
        t1 = time.perf_counter()
        if not record:
            return
        every, first = self.sample
        if len(self.latencies) % every == first:
            self.answers.append((i, pred, post, ratios))
        self.latencies.append(t1 - t0)

    def warm(self):
        for _ in range(len(self.preps)):
            self.collect(self.dispatch(), record=False)

    def run(self, seconds, profiled=None, profile_after=0.0,
            profile_units=0):
        pending = collections.deque()
        k0 = self.k
        t_start = time.perf_counter()
        stop, prof_state, done = False, 0, 0
        while True:
            while not stop and len(pending) < self.in_flight:
                if time.perf_counter() - t_start >= seconds:
                    stop = True
                    break
                pending.append(self.dispatch())
            if not pending:
                break
            self.collect(pending.popleft())
            done += 1
            if profiled is not None and prof_state == 0 and \
                    time.perf_counter() - t_start >= profile_after:
                profiled.start()
                prof_state, first = 1, done
            elif prof_state == 1 and done - first >= profile_units:
                profiled.stop(done - first)
                prof_state = 2
        if prof_state == 1:
            profiled.stop(done - first)
        return {"done": done, "attempted": self.k - k0,
                "window_s": time.perf_counter() - t_start,
                "latencies_s": self.latencies}


def run(cfg, traffic, seed, seconds, trace, device, fault=None,
        profiled=None, on_setup_done=None):
    phase = harness.Phases()
    from dram_tpu_torch.infer.fast import FastScanPipeline
    phase("port imported")
    v = cfg["values"]
    model, state = build.model_and_state(cfg, seed, device)
    phase("model and weights")
    if fault == "half_batch":
        n = len(traffic["lesion_severity"])
        drop = list(range(n - n // 2, n))
        stage = model.forward

        def half(x):
            keep = torch.ones(x.shape[0], 1, 1, 1, 1, dtype=x.dtype,
                              device=x.device)
            keep[drop] = 0
            return stage(x * keep)
        model.forward = half
    pipe = FastScanPipeline(model, device=device,
                            chunk_size=tuple(v["RESAMPLE_SIZE"]),
                            windowing_span=(v["WINDOWING_MIN"],
                                            v["WINDOWING_MAX"]))
    scans = make_scans(seed, traffic, device)
    phase("scans")
    preps = prep(scans, cfg, traffic)
    phase("prep")
    rng = np.random.default_rng(int(seed) % 2 ** 63)
    order = [int(i) for i in rng.permutation(len(preps))]
    every = int(traffic["check_every"])
    loop = Loop(pipe, preps, order, int(traffic["in_flight"]), device,
                (every, int(rng.integers(every))), fault)
    loop.warm()
    if profiled is not None:
        profiled.warm()
    phase("warm-up")
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    if on_setup_done is not None:
        on_setup_done()
    window = loop.run(seconds, profiled,
                      float(traffic["profile_after_s"]) if trace else 0.0,
                      int(traffic["profile_scans"]))
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    phase("window")
    answers = loop.answers
    del pipe, model, loop
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, per_answer = check(answers, scans, preps, state, cfg, traffic,
                                device)
    phase("reference check")
    return {"window": window, "numbers": numbers, "per_unit": per_answer,
            "attempted": window["attempted"], "peak_bytes": peak}


KEYS = ("pred_diff", "post_diff", "ratio_gap")


def gaps(mine, ref):
    """The numbers of one answer against the reference's, both {"pred",
    "post": bool on the full iso grid, "ratios"} or mine None (an answer
    that does not fit the grid): pred_diff and post_diff, the voxels
    where the masks before and after the post rule differ over the
    reference's mask voxels; ratio_gap, the largest lobe ratio gap."""
    if mine is None:
        return dict.fromkeys(KEYS, float("inf"))
    out = {}
    for k in ("pred", "post"):
        out[f"{k}_diff"] = float((mine[k] ^ ref[k]).sum()) \
            / max(float(ref[k].sum()), 1.0)
    out["ratio_gap"] = float(np.max(np.abs(
        np.asarray(mine["ratios"], np.float64)
        - np.asarray(ref["ratios"], np.float64))))
    return out


def on_grid(pred_packed, post_packed, ratios, prep, ref):
    """The program's packed iso-crop answer placed on the reference's
    full iso grid ({"pred", "post", "ratios"}), or None where its crop
    does not fit."""
    shape = tuple(prep["iso_shape"])
    n = int(np.prod(shape))
    sl = tuple(slice(int(a), int(a) + s)
               for a, s in zip(prep["crop_lo"], shape))
    if any(s.stop > f for s, f in zip(sl, ref["pred"].shape)):
        return None
    out = {"ratios": ratios}
    for k, packed in (("pred", pred_packed), ("post", post_packed)):
        bits = np.unpackbits(np.asarray(packed, np.uint8))[:n]
        m = torch.zeros_like(ref["pred"])
        m[sl] = torch.from_numpy(bits.reshape(shape).astype(bool)).to(
            m.device)
        out[k] = m
    return out


def reference_answers(scans, state, cfg, traffic, device, quant="exact",
                      drop_lobes=()):
    out = []
    for scan, lobe, spacing in scans:
        out.append(ref_scan.run_scan(
            torch.from_numpy(scan).to(device),
            torch.from_numpy(lobe).to(device), spacing, state, cfg["values"],
            traffic, quant, drop_lobes))
    return out


def check(answers, scans, preps, state, cfg, traffic, device):
    """The worst numbers over the answers kept from the window (every
    `check_every`-th from an offset drawn from the seed; the stride is
    prime to the mix's six scans, so every scan has answers in the
    sample), and each answer's numbers. No answer reads inf."""
    refs = reference_answers(scans, state, cfg, traffic, device)
    per_answer = [gaps(on_grid(p, q, r, preps[i], refs[i]), refs[i])
                  for i, p, q, r in answers]
    return worst(per_answer), per_answer


def worst(per_answer):
    """The largest of each number over the answers (inf without any)."""
    return {k: max((a[k] for a in per_answer), default=float("inf"))
            for k in KEYS}

#!/usr/bin/env python3
"""Readings that set a cell's limits (not run by the benchmark's own
runs; run it on the card).

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,...
                                   [--controls 3] [--seconds 1]

For each seed, in one process: the sound program through the cell's own
driver (set-up, a `--seconds` window, the check against the reference),
printing its numbers; for the first `--controls` seeds also the control
(the reference computed with fp8 operands, put in the program's place)
and the faults read in the reference's place (half of each batch, or of
each scan's chunks, left out), by the driver's own `readings(cfg,
traffic, seed, device)` where it defines one, else by its family's
below. One JSON line each: {"workload", "seed", "what", "numbers",
"rejected", "s"}; "rejected" says whether the cell's committed limits
(limits/<workload>.json) fail the numbers, by the comparison that
decides a run's `correct`."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import run as bench_run  # noqa: E402
from portbench.lib import build, harness, scan_infer, train_step  # noqa: E402
from portbench.reference import train as ref_train  # noqa: E402


def _emit(workload, seed, what, numbers, t0, limits):
    print(json.dumps({"workload": workload, "seed": seed, "what": what,
                      "numbers": numbers,
                      "rejected": not harness.checks_line(numbers,
                                                          limits)[1],
                      "s": round(time.perf_counter() - t0, 3)}), flush=True)


def train_readings(cfg, traffic, seed, device):
    """{what: numbers} of the control (fp8) and the half-batch fault,
    each against the exact reference from the same start."""
    from dram_tpu_torch.train.trainer import build_model
    with torch.device("meta"):
        model = build_model(build.settings(cfg), build.dtype(cfg))
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    state0 = build.seeded_state(shapes, seed, device)
    batches = train_step.make_batches(seed, cfg, traffic, device)
    n = int(traffic["checked_steps"])
    ref = ref_train.steps(state0, batches, cfg["values"], n)
    out = {}
    for what, kw in (("control_fp8", {"quant": "fp8"}),
                     ("fault_half_batch",
                      {"rows": int(cfg["values"]["TRAIN_BATCH_SIZE"]) // 2})):
        other = ref_train.steps(state0, batches, cfg["values"], n, **kw)
        out[what] = train_step.compare(other, ref, state0)
        del other
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def infer_readings(cfg, traffic, seed, device):
    """{what: numbers} of the control (fp8) and of half of each scan's
    chunks left out, each the worst over the mix's scans against the
    exact reference, by the comparison that decides a run."""
    _, state = build.model_and_state(cfg, seed, device)
    scans = scan_infer.make_scans(seed, traffic, device)
    ref = scan_infer.reference_answers(scans, state, cfg, traffic, device)
    n = len(traffic["lesion_severity"])
    out = {}
    for what, kw in (("control_fp8", {"quant": "fp8"}),
                     ("fault_half_batch",
                      {"drop_lobes": tuple(range(n - n // 2, n))})):
        other = scan_infer.reference_answers(scans, state, cfg, traffic,
                                             device, **kw)
        out[what] = scan_infer.worst([scan_infer.gaps(a, b)
                                      for a, b in zip(other, ref)])
    return out


def readings(cfg, traffic, seed, device):
    """The driver's own `readings` where it has one, else its family's."""
    fn = getattr(harness.driver(traffic), "readings", None) or (
        train_readings if harness.family(traffic) == "train"
        else infer_readings)
    return fn(cfg, traffic, seed, device)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("calibrate: needs a CUDA device")
    _, cfg, traffic, limits = harness.cell(args.workload)
    device = torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        numbers = {}
        bench_run.run_cell(args.workload, seed, args.seconds, 0,
                           numbers=numbers)
        _emit(args.workload, seed, "sound", numbers, t0, limits)
        torch.cuda.empty_cache()
        if i < args.controls:
            t0 = time.perf_counter()
            for what, nums in readings(cfg, traffic, seed, device).items():
                _emit(args.workload, seed, what, nums, t0, limits)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

The cell, its configuration and traffic come from BENCHMARK.json and
the files it names (portbench/configs, portbench/traffic,
portbench/limits); each metric from portbench/metrics/<name>.py. With
--trace 0 the result holds the cell's end-to-end metrics, with --trace
1 its per-layer metrics, read from a short profiled part of the window.
The last line of standard output is one JSON object: correct,
attempted, failed, metrics, device, (breakdown,) checks. The numbers
compared with their limits also end standard error. Needs CUDA and as
many cards as the cell asks for; exits non-zero, with no result, when
they are missing, when a check cannot run, or when jax, jaxlib, flax or
the JAX package (dram_tpu) were loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench.lib import harness  # noqa: E402


def run_cell(workload, seed, seconds, trace, device="cuda", fault=None,
             bench=None, overrides=None, numbers=None):
    """The result dict of one run (the result line's keys) and the
    checks' stderr lines. `overrides` replaces files of the cell
    ({"config": ..., "traffic": ..., "limits": ...}); `fault` plants a
    fault in the timed path (tests and calibration only); a `numbers`
    dict receives every number the driver compared, those without a
    limit too (calibration)."""
    bench = bench or harness.manifest()
    wl, cfg, traffic, limits = harness.cell(workload, bench)
    overrides = overrides or {}
    cfg = overrides.get("config", cfg)
    traffic = overrides.get("traffic", traffic)
    limits = overrides.get("limits", limits)
    device = torch.device(device)
    driver = importlib.import_module(f"portbench.lib.{traffic['kind']}")
    from portbench.lib.profiling import Profiled
    profiled = Profiled(device) if trace else None
    marks = {}
    out = driver.run(cfg, traffic, seed, seconds, trace, device, fault,
                     profiled,
                     on_setup_done=lambda: marks.setdefault(
                         "setup", time.perf_counter()))
    ctx = {"workload": workload, "config": cfg, "traffic": traffic,
           "window": out["window"],
           "setup_s": marks["setup"] - T_START,
           "prof": profiled.readings() if profiled and profiled.prof
           else None}
    metrics = {}
    for m in harness.metrics_of(bench, workload, trace):
        v = harness.read_metric(m["name"], ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if numbers is not None:
        numbers.update(out["numbers"])
    checks, ok = harness.checks_line(out["numbers"], limits)
    failed = out["attempted"] - out["window"]["done"] \
        + out.get("window_bad", 0)
    failed += sum(1 for nums in out["per_unit"]
                  if any(not nums[k] <= float(v) for k, v in limits.items()))
    dev = harness.device_info(torch, int(wl["chips"]))
    dev["memory_peak_bytes"] = int(out["peak_bytes"])
    if ctx["prof"] is not None:
        dev["busy_s"] = ctx["prof"]["busy_s"]
        dev["window_s"] = ctx["prof"]["window_s"]
    result = {"correct": bool(ok and failed == 0),
              "attempted": int(out["attempted"]), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if ctx["prof"] is not None:
        result["breakdown"] = ctx["prof"]["breakdown"]
    result["checks"] = checks
    lines = [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
             for k, v in checks.items()]
    return result, lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build cache a library could keep, inside the checkout at fixed
    # paths (the port builds its kernels into dram_tpu_torch/_build)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, os.path.join(ROOT, "portbench", ".cache",
                                                sub))
    bench = harness.manifest()
    wl = harness.cell(args.workload, bench)[0]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        print(f"portbench: {args.workload} needs {wl['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"phase imports and device check: "
          f"{time.perf_counter() - T_START:.3f} s", file=sys.stderr)
    result, lines = run_cell(args.workload, args.seed, args.seconds,
                             args.trace, "cuda", bench=bench)
    banned = harness.banned_modules()
    if banned:
        print(f"portbench: the run loaded {banned}", file=sys.stderr)
        return 3
    print(harness.host_line(), file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

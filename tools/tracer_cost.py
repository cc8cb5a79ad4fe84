#!/usr/bin/env python3
"""One run of a benchmark cell with the port's tracer forced on or left
off, for the tracer's cost when on (no profiler: spans, CUDA events and
records, without profiler ranges).

    python3 tools/tracer_cost.py --workload <name> --seed <n> \\
        --seconds <s> --tracer <0|1>

Runs portbench's cell as `portbench/run.py --trace 0` does and prints
its result line with "tracer" and the number of spans recorded added.
Compare the two settings in turns on one card."""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import run as bench_run  # noqa: E402

from dram_tpu_torch import tracing  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tracer", type=int, choices=(0, 1), required=True)
    args = ap.parse_args()
    if args.tracer:
        with tracing.recording():
            res, _ = bench_run.run_cell(args.workload, args.seed,
                                        args.seconds, 0)
    else:
        res, _ = bench_run.run_cell(args.workload, args.seed, args.seconds,
                                    0)
    res["tracer"] = args.tracer
    res["spans"] = len(tracing.snapshot()["spans"])
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()

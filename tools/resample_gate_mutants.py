#!/usr/bin/env python3
"""Readings of chip_smoke.py's `resample interpolators` and `engine
resample mode` gates for the sound tree and for deliberately broken
copies of it, on one NVIDIA GPU.

    python3 tools/resample_gate_mutants.py [--variants a,b]

For each variant the script copies dram_tpu_torch/ and chip_smoke.py
into a temporary directory, changes one line there (the checkout is
never changed) and, in the copy, runs the gate the line feeds and prints
what it reads: whether each check passes, and the message of the first
that fails. Variants:

- sound: the tree as it is (both gates);
- sinc_tap: the windowed sincs drop their last tap (interpolators);
- no_prefilter: the B-spline weights leave out the prefilter, the plain
  cubic B-spline basis (interpolators);
- odd_plane_start: a pooled block of an odd extent drops its first
  plane, row or column instead of its last (the engine at the ragged
  grid).
"""

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from kernel_copies import card_line, make_copy, run_in_copy  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESAMPLE = "core/resample.py"
BLOCKS = "models/blocks.py"
VARIANTS = {
    "sound": (None, ("interpolators", "engine")),
    "sinc_tap": ((RESAMPLE, "        for k in range(-m + 1, m + 1):",
                  "        for k in range(-m + 1, m):"), ("interpolators",)),
    "no_prefilter": ((RESAMPLE, "        W = B @ _bspline_coeff_matrix("
                      "in_size).astype(np.float64)", "        W = B"),
                     ("interpolators",)),
    "odd_plane_start": ((BLOCKS, "y[:, :even[0], :even[1], :even[2]]",
                         "y[:, y.shape[1] - even[0]:, y.shape[2] - even[1]:,"
                         " y.shape[3] - even[2]:]"), ("engine",)),
}
LIMIT_S = 600


def read(gates, bench):
    """Run in a copy's directory: the named gates of that copy (the
    engine's from the trained weights at `bench`)."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    import torch
    from dram_tpu_torch import weights
    from dram_tpu_torch.kernels import _build
    from dram_tpu_torch.train.checkpoint import save_checkpoint
    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    scan, lobe, _, _, _ = cs.synth_scan(np.random.default_rng(cs.SEED),
                                        cs.SCAN_SHAPE,
                                        lesion_severity=cs.SEVERITIES)
    for gate in gates.split(","):
        try:
            if gate == "interpolators":
                cs.resample_interpolators_phase(scan, lobe, card)
            else:
                _build.load()
                params, stats = weights.load_bench_weights(bench)
                with tempfile.TemporaryDirectory() as root:
                    ckpt = f"{root}/1.ckpt"
                    save_checkpoint(ckpt, {"model": {
                        "params": params, "batch_stats": stats},
                        "epoch": 1, "iteration": 0})
                    deploy = cs.write_deploy_dirs(root, scan, lobe)
                    cs.engine_stitch_phase(root, ckpt, deploy, card,
                                           resample_mode=cs.RAGGED_MODE)
            print(f"# reading {gate}: the gate passes", flush=True)
        except SystemExit as e:
            print(f"# reading {gate}: the gate fails: {e}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", help="comma-separated names to read "
                    "(default: all)")
    args = ap.parse_args()
    variants = VARIANTS
    if args.variants:
        names = args.variants.split(",")
        unknown = set(names) - set(variants)
        if unknown:
            raise SystemExit(f"unknown variants {sorted(unknown)}")
        variants = {k: variants[k] for k in names}
    print(card_line(), flush=True)
    bench = os.path.join(ROOT, "assets", "bench_weights.ckpt.xz")
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, (change, gates) in variants.items():
            d = make_copy(tmp, name, [change] if change is not None else [])
            print(f"# variant {name}: "
                  f"{'as in the tree' if change is None else change[2]}",
                  flush=True)
            try:
                rc = run_in_copy(d, __file__, ["--read", ",".join(gates),
                                               bench], LIMIT_S)
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                print(f"# variant {name} exited {rc}", flush=True)
                failed.append(name)
    if failed:
        raise SystemExit(f"variants that did not run to the end: {failed}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--read"]:
        read(sys.argv[2], sys.argv[3])
    else:
        main()

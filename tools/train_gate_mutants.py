#!/usr/bin/env python3
"""Readings of chip_smoke.py's train gate for the sound kernels and for
deliberately broken copies of them, on one NVIDIA GPU.

    python3 tools/train_gate_mutants.py

For each variant the script copies dram_tpu_torch/ and chip_smoke.py
into a temporary directory, breaks one line of a CUDA source there (the
checkout is never changed), builds that copy's kernels and runs the
train gate's comparison: TRAIN_STEPS st_dram_ref steps with the kernels,
the same steps with the plain versions, then chip_smoke.compare_train,
whose line it prints with "pass" or the failure instead of exiting.
Variants:

- sound: the tree as it is;
- dw64: the weight-gradient kernel skips every 64th voxel of K (1.6%);
- dw8: it skips every 8th voxel (12.5%);
- st64: the conv kernel's statistics skip one row in each 64-row block.
"""

import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join("dram_tpu_torch", "kernels", "csrc")
DW_LINE = "    const bool vok = v < kend;"
ST_LINE = "      if (m0 + r < V) {"
VARIANTS = {
    "sound": None,
    "dw64": ("conv3x3x3_dw.cu", DW_LINE,
             "    const bool vok = v < kend && (v & 63) != 0;"),
    "dw8": ("conv3x3x3_dw.cu", DW_LINE,
            "    const bool vok = v < kend && (v & 7) != 0;"),
    "st64": ("conv3x3x3.cu", ST_LINE, "      if (m0 + r < V && r != 0) {"),
}
LIMIT_S = 300


def read_gate():
    """Run in a copy's directory: the train gate's readings of that
    copy."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from dram_tpu_torch import weights
    from dram_tpu_torch.configs import st_dram_ref
    from dram_tpu_torch.data.synth import train_batch
    from dram_tpu_torch.kernels import _build
    from dram_tpu_torch.models import DC3D

    if not cs.__file__.startswith(os.getcwd()):
        raise SystemExit(f"imported {cs.__file__}, not the copy's")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    bench = os.path.join(ROOT, "assets", "bench_weights.ckpt.xz")
    batch = train_batch(cs.SEED, batch=st_dram_ref.TRAIN_BATCH_SIZE,
                        size=st_dram_ref.RESAMPLE_SIZE[0],
                        window=(st_dram_ref.WINDOWING_MIN,
                                st_dram_ref.WINDOWING_MAX))
    k_run = cs.run_train("kernels", batch, bench)
    torch.cuda.empty_cache()
    with cs.plain_versions():
        p_run = cs.run_train("plain versions", batch, bench)
    start = weights.load_backbone(
        DC3D(stacking=st_dram_ref.MODEL["stacking"]), bench)
    initial = dict(start.named_buffers())
    try:
        cs.compare_train(k_run, p_run, initial)
        print("# gate: pass", flush=True)
    except SystemExit as e:
        print(f"# gate: {e}", flush=True)


def main():
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=20).stdout.strip(), flush=True)
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, change in VARIANTS.items():
            d = os.path.join(tmp, name)
            shutil.copytree(os.path.join(ROOT, "dram_tpu_torch"),
                            os.path.join(d, "dram_tpu_torch"),
                            ignore=shutil.ignore_patterns("_build",
                                                          "__pycache__"))
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), d)
            if change is not None:
                src, old, new = change
                path = os.path.join(d, CSRC, src)
                text = open(path).read()
                if text.count(old) != 1:
                    raise SystemExit(f"{name}: line not found once in {src}")
                with open(path, "w") as fp:
                    fp.write(text.replace(old, new))
            print(f"# variant {name}: "
                  f"{'as in the tree' if change is None else change[2]}",
                  flush=True)
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--read"], cwd=d, timeout=LIMIT_S)
            if r.returncode != 0:
                print(f"# variant {name} exited {r.returncode}", flush=True)
                failed.append(name)
    if failed:
        raise SystemExit(f"variants that did not run to the end: {failed}")


if __name__ == "__main__":
    if sys.argv[1:] == ["--read"]:
        read_gate()
    else:
        main()

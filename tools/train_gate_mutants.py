#!/usr/bin/env python3
"""Readings of chip_smoke.py's train gate for the sound kernels and for
deliberately broken copies of them, on one NVIDIA GPU.

    python3 tools/train_gate_mutants.py [--config st_dram_ref_att]
                                        [--unfused]

For each variant the script copies dram_tpu_torch/ and chip_smoke.py
into a temporary directory, breaks one line of a CUDA source there (the
checkout is never changed), builds that copy's kernels and runs the
train gate's comparison: TRAIN_STEPS steps of the configuration with the
kernels, the same steps with the plain versions, then
chip_smoke.compare_train, whose lines it prints with "pass" or the
failure instead of exiting. Variants of st_dram_ref (the default):

- sound: the tree as it is;
- dw64: the weight-gradient kernel skips every 64th voxel of K (1.6%);
- dw8: it skips every 8th voxel (12.5%);
- st64: the conv kernel's statistics skip one row in each 64-row block.

Variants of st_dram_ref_att (the flagship, the attention kernels):

- sound: the tree as it is;
- dphi1: the attention gradient pass drops the -o contribution of one of
  the 18 offsets, (-1, -1, 0), to dphi;
- c_undiv: the statistics pass leaves c undivided by denom.

Variants of st_dram_ref_att with --unfused (USE_FUSED_STACK = False: the
raw conv and its dW, the first-maximum max-pool backward):

- sound: the tree as it is;
- dw64: as above, the weight-gradient kernel skips every 64th voxel of K;
- tie_last: the first-maximum pool backward gives the cotangent to the
  LAST tied maximum of each window.
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join("dram_tpu_torch", "kernels", "csrc")
DW_LINE = "    const bool vok = v < kend;"
ST_LINE = "      if (m0 + r < V) {"
SA = "stencil_attention.cu"
DPHI_LINE = "        for (int c = 0; c < F; ++c) dph[c] += ds2 * ti[c];"
C_LINE = "    const float c = num / fmaxf(denom, 1e-12f);"
ATT_VARIANTS = {
    "sound": None,
    "dphi1": (SA, DPHI_LINE, "        for (int c = 0; c < F; ++c) "
              "dph[c] += (k == 1 ? 0.f : ds2) * ti[c];"),
    "c_undiv": (SA, C_LINE, "    const float c = num;"),
}
DW64 = ("conv3x3x3_dw.cu", DW_LINE,
        "    const bool vok = v < kend && (v & 63) != 0;")
PICK_LINE = "        if (tie && pick[k] == 8) pick[k] = t;"
UNFUSED_VARIANTS = {
    "sound": None,
    "dw64": DW64,
    "tie_last": ("maxpool2.cu", PICK_LINE, "        if (tie) pick[k] = t;"),
}
VARIANTS = {
    "sound": None,
    "dw64": DW64,
    "dw8": ("conv3x3x3_dw.cu", DW_LINE,
            "    const bool vok = v < kend && (v & 7) != 0;"),
    "st64": ("conv3x3x3.cu", ST_LINE, "      if (m0 + r < V && r != 0) {"),
}
LIMIT_S = 300


def read_gate(config, unfused):
    """Run in a copy's directory: the train gate's readings of that
    copy for `config` (with USE_FUSED_STACK = False when `unfused`)."""
    sys.path.insert(0, os.getcwd())
    import importlib

    import torch

    import chip_smoke as cs
    from dram_tpu_torch import weights
    from dram_tpu_torch.configs import with_settings
    from dram_tpu_torch.data.synth import train_batch
    from dram_tpu_torch.kernels import _build
    from dram_tpu_torch.models import DC3D, DC3DATGeneric

    if not cs.__file__.startswith(os.getcwd()):
        raise SystemExit(f"imported {cs.__file__}, not the copy's")
    settings = importlib.import_module(f"dram_tpu_torch.configs.{config}")
    if unfused:
        settings = with_settings(settings, USE_FUSED_STACK=False)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    bench = os.path.join(ROOT, "assets", "bench_weights.ckpt.xz")
    batch = train_batch(cs.SEED, batch=settings.TRAIN_BATCH_SIZE,
                        size=settings.RESAMPLE_SIZE[0],
                        window=(settings.WINDOWING_MIN,
                                settings.WINDOWING_MAX))
    att = config == "st_dram_ref_att"
    tag = ("unfused " if unfused else "att ") if att else ""
    k_run = cs.run_train(settings, tag + "kernels", batch, bench)
    torch.cuda.empty_cache()
    with cs.plain_versions():
        p_run = cs.run_train(settings, tag + "plain versions", batch, bench)
    if att:
        start = weights.load_into(DC3DATGeneric(),
                                  *weights.load_bench_weights(bench))
    else:
        start = weights.load_backbone(
            DC3D(stacking=settings.MODEL["stacking"]), bench)
    initial = dict(start.named_buffers())
    try:
        cs.compare_train(k_run, p_run, initial, "train " + tag.strip()
                         if att else "train")
        print("# gate: pass", flush=True)
    except SystemExit as e:
        print(f"# gate: {e}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="st_dram_ref",
                    choices=("st_dram_ref", "st_dram_ref_att"))
    ap.add_argument("--unfused", action="store_true",
                    help="st_dram_ref_att with USE_FUSED_STACK = False")
    args = ap.parse_args()
    if args.unfused and args.config != "st_dram_ref_att":
        raise SystemExit("--unfused goes with --config st_dram_ref_att")
    variants = UNFUSED_VARIANTS if args.unfused else ATT_VARIANTS \
        if args.config == "st_dram_ref_att" else VARIANTS
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=20).stdout.strip(), flush=True)
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, change in variants.items():
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
                                "--read", args.config,
                                str(int(args.unfused))], cwd=d,
                               timeout=LIMIT_S)
            if r.returncode != 0:
                print(f"# variant {name} exited {r.returncode}", flush=True)
                failed.append(name)
    if failed:
        raise SystemExit(f"variants that did not run to the end: {failed}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--read"]:
        read_gate(sys.argv[2], sys.argv[3] == "1")
    else:
        main()

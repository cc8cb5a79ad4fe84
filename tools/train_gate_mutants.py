#!/usr/bin/env python3
"""Readings of chip_smoke.py's train gate for the sound kernels and for
deliberately broken copies of them, on one NVIDIA GPU.

    python3 tools/train_gate_mutants.py [--config st_dram_ref_att]
                                        [--unfused | --golden]

For each variant the script copies dram_tpu_torch/ and chip_smoke.py
into a temporary directory, breaks one line of a CUDA source there (the
checkout is never changed), builds that copy's kernels and runs the
train gate's comparison: TRAIN_STEPS steps of the configuration with the
kernels, the same steps with the plain versions, then
chip_smoke.compare_train, whose lines it prints with "pass" or the
failure instead of exiting. Variants of st_dram_ref (the default):

- sound: the tree as it is;
- dw64: the weight-gradient kernel skips every 64th K box (1.6% of K):
  its dy box is loaded from outside the volume, all zeros;
- dw8: it skips every 8th K box (12.5%);
- st64: the conv kernel's statistics skip one row in each 64-row wgmma
  tile (the first voxel of each 8 x 8 z-plane of a tile).

Variants of st_dram_ref_att (the flagship, the attention kernels):

- sound: the tree as it is;
- dphi1: the attention gradient pass drops the -o contribution of one of
  the 18 offsets, (-1, -1, 0), to dphi;
- c_undiv: the statistics pass leaves c undivided by denom;
- fwd_halo: the attention forward's plane ring skips each tile's -1 halo
  row (the buffer's first row keeps whatever it held);
- scal_late: the attention gradient pass reads the statistics of the
  neighbours a plane behind from the plane after them (one plane late).

Variants of st_dram_ref_att with --unfused (USE_FUSED_STACK = False: the
raw conv and its dW, the first-maximum max-pool backward):

- sound: the tree as it is;
- dw64: as above, the weight-gradient kernel skips every 64th K box;
- tie_last: the first-maximum pool backward gives the cotangent to the
  LAST tied maximum of each window.

With --golden (the flagship, fused stack) each variant reads three gates:
the kernel checks (chip_smoke's upsample sweep against the plain
versions, and the weight gradient against its plain version at us_2's
conv_0, [128|64] -> 64 at batch 2 x 80^3, within 1e-3 of the largest),
the flagship's train gate (kernels vs plain) and the train golden gate
(the kernel step against dram_tpu's float64 step, chip_smoke's `train
golden` phase). Variants:

- sound: the tree as it is;
- dw64: as above;
- bwd_lastz: the upsample adjoint drops the last dy plane each tile
  streams (the last z tap of its last input plane);
- fwd_edge: the upsample forward's edge tile ends one output row short
  (the last row of the volume is never written);
- st64: as above, the conv kernel's statistics skip one row in 64 (a
  forward fault: it moves the BatchNorm batch statistics);
- dphi1: as above, the attention gradient drops one offset's -o
  contribution to dphi (a fault of the PCM's gradient);
- fwd_halo, scal_late: as above, the two attention staging faults.

With --golden the kernel checks also run chip_smoke's attention sweep.
`--variants a,b` reads only the named variants.
"""

import argparse
import os
import sys
import tempfile

from kernel_copies import ROOT, card_line, make_copy, run_in_copy

DW_LINE = ("        wg::tma_load_5d(st + DW_A_BYTES, &map_dy, &full[s], n0, x0, "
           "y0, z0,")
ST_LINE = "                    valid[s][h] ? acc[s][q * 4 + h * 2 + e] : 0.f;"
SA = "stencil_attention.cu"
DPHI_LINE = ("          for (int e = 0; e < F; ++e) "
             "dph[e] = fmaf(ds2, ti[e], dph[e]);")
C_LINE = "    const float c = num / fmaxf(denom, 1e-12f);"
HALO_LINE = "  const int sr0 = t.ry0, sr1 = t.ry1;"
SCAL_LINE = "          const float* ss = sp;"
ATT_VARIANTS = {
    "sound": None,
    "dphi1": (SA, DPHI_LINE, "          for (int e = 0; e < F; ++e) "
              "dph[e] = fmaf(k == 1 ? 0.f : ds2, ti[e], dph[e]);"),
    "c_undiv": (SA, C_LINE, "    const float c = num;"),
    "fwd_halo": (SA, HALO_LINE, "  const int sr0 = t.ya, sr1 = t.ry1;"),
    "scal_late": (SA, SCAL_LINE,
                  "          const float* ss = dz > 0 ? slot[1] : sp;"),
}
DW64 = ("conv3x3x3_dw.cu", DW_LINE,
        "        wg::tma_load_5d(st + DW_A_BYTES, &map_dy, &full[s], n0, x0, "
        "y0, (kb & 63) ? z0 : -DW_BZ,")
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
            "        wg::tma_load_5d(st + DW_A_BYTES, &map_dy, &full[s], n0, "
            "x0, y0, (kb & 7) ? z0 : -DW_BZ,"),
    "st64": ("conv3x3x3.cu", ST_LINE,
             "                    valid[s][h] && (warp | h | (lane >> 2)) "
             "? acc[s][q * 4 + h * 2 + e] : 0.f;"),
}
UP = "upsample2x.cu"
GOLDEN_VARIANTS = {
    "sound": None,
    "dw64": DW64,
    "bwd_lastz": (UP, "    if (active) {\n      const __nv_bfloat16* buf",
                  "    if (active && pl < pz1) {\n"
                  "      const __nv_bfloat16* buf"),
    "fwd_edge": (UP, "const int ya = ty * p.yr, yb = min(ya + p.yr, 2 * H);",
                 "const int ya = ty * p.yr, yb = min(ya + p.yr, 2 * H - 1);"),
    "st64": VARIANTS["st64"],
    "dphi1": ATT_VARIANTS["dphi1"],
    "fwd_halo": ATT_VARIANTS["fwd_halo"],
    "scal_late": ATT_VARIANTS["scal_late"],
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


def read_golden():
    """Run in a copy's directory: the kernel checks, the flagship's train
    gate and the train golden gate of that copy, each printed with
    "pass" or its failure."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from dram_tpu_torch import weights
    from dram_tpu_torch.configs import st_dram_ref_att as settings
    from dram_tpu_torch.data.synth import train_batch
    from dram_tpu_torch.kernels import _build, conv_stack
    from dram_tpu_torch.models import DC3DATGeneric

    if not cs.__file__.startswith(os.getcwd()):
        raise SystemExit(f"imported {cs.__file__}, not the copy's")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)

    def gate(name, fn):
        try:
            fn()
            print(f"# {name}: pass", flush=True)
        except SystemExit as e:
            print(f"# {name}: {e}", flush=True)

    def dw_check():
        x1, x2, dy = (torch.randn(2, 80, 80, 80, c, generator=gen,
                                  device="cuda").to(torch.bfloat16)
                      for c in (128, 64, 64))
        a = conv_stack.conv3x3x3_dw(x1, dy, x2=x2)
        b = conv_stack.conv3x3x3_dw_plain(x1, dy, x2=x2)
        err = (a - b).abs().max().item() / b.abs().max().item()
        print(f"# kernel check dW [128|64] -> 64 at 2 x 80^3: error "
              f"{err:.3g} of the largest (allowed 1e-3)", flush=True)
        if not err <= 1e-3:
            cs.fail("dW disagrees with its plain version")
    gate("kernel check upsample sweep", lambda: cs.upsample_sweep_phase(gen))
    gate("kernel check dW", dw_check)
    gate("kernel check attention sweep",
         lambda: cs.attention_sweep_phase(gen))
    torch.cuda.empty_cache()
    bench = os.path.join(ROOT, "assets", "bench_weights.ckpt.xz")
    batch = train_batch(cs.SEED, batch=settings.TRAIN_BATCH_SIZE,
                        size=settings.RESAMPLE_SIZE[0],
                        window=(settings.WINDOWING_MIN,
                                settings.WINDOWING_MAX))
    initial = dict(weights.load_into(
        DC3DATGeneric(), *weights.load_bench_weights(bench)).named_buffers())

    def train_gate():
        k_run = cs.run_train(settings, "att kernels", batch, bench)
        torch.cuda.empty_cache()
        with cs.plain_versions():
            p_run = cs.run_train(settings, "att plain versions", batch,
                                 bench)
        cs.compare_train(k_run, p_run, initial, "train att")
    gate("train gate", train_gate)
    torch.cuda.empty_cache()
    gate("train golden gate", lambda: cs.train_golden_phase(
        bench, {}, (("train_golden", settings),)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="st_dram_ref",
                    choices=("st_dram_ref", "st_dram_ref_att"))
    ap.add_argument("--unfused", action="store_true",
                    help="st_dram_ref_att with USE_FUSED_STACK = False")
    ap.add_argument("--golden", action="store_true",
                    help="the kernel checks, the flagship's train gate and "
                    "the train golden gate of the upsample and dW variants")
    ap.add_argument("--variants", help="comma-separated names to read "
                    "(default: all of the mode's)")
    args = ap.parse_args()
    if args.unfused and args.config != "st_dram_ref_att":
        raise SystemExit("--unfused goes with --config st_dram_ref_att")
    variants = GOLDEN_VARIANTS if args.golden else UNFUSED_VARIANTS \
        if args.unfused else ATT_VARIANTS \
        if args.config == "st_dram_ref_att" else VARIANTS
    if args.variants:
        names = args.variants.split(",")
        unknown = set(names) - set(variants)
        if unknown:
            raise SystemExit(f"unknown variants {sorted(unknown)}")
        variants = {k: variants[k] for k in names}
    print(card_line(), flush=True)
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, change in variants.items():
            d = make_copy(tmp, name, [change] if change is not None else [])
            print(f"# variant {name}: "
                  f"{'as in the tree' if change is None else change[2]}",
                  flush=True)
            rc = run_in_copy(d, __file__, ["--read-golden"] if args.golden
                             else ["--read", args.config,
                                   str(int(args.unfused))], LIMIT_S)
            if rc != 0:
                print(f"# variant {name} exited {rc}", flush=True)
                failed.append(name)
    if failed:
        raise SystemExit(f"variants that did not run to the end: {failed}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--read-golden"]:
        read_golden()
    elif sys.argv[1:2] == ["--read"]:
        read_gate(sys.argv[2], sys.argv[3] == "1")
    else:
        main()

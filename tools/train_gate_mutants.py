#!/usr/bin/env python3
"""Readings of chip_smoke.py's train gate for the sound kernels and for
deliberately broken copies of them, on one NVIDIA GPU.

    python3 tools/train_gate_mutants.py [--config st_dram_ref_att]
                                        [--unfused | --golden | --generic
                                         | --variant-b | --dp | --entry]

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

With --generic (the generic stencil-attention kernels,
csrc/stencil_attention_generic.cu) each variant reads chip_smoke's
generic attention checks (every stencil and width of GENERIC_CASES
against the plain versions) and variant A's train gate (the flagship
with a k = 5, connectivity-2, self-loop PCM of widths 16 / 4 on the
generic kernels, from the trained backbone):

- sound: the tree as it is;
- dphi_plus: the gradient pass's -o side gathers dphi and dg over i = j +
  o instead of j - o (right on a symmetric stencil, wrong on k = 5's);
- fwd_drop_last: the forward skips the stencil's last offset;
- halo_stale: the producer of every generic plane ring (forward,
  statistics pass, both gradient sides) never stages a tile's first halo
  plane below the tile; its buffer holds the tile's first plane instead
  (the dz = -h taps of that plane read a wrong plane);
- last_col: every generic plane-ring kernel leaves each tile's last
  column uncomputed;
- no_rescale: the forward's online softmax never rescales its
  denominator and accumulators when the running maximum grows;
- scal_num_stale: the statistics pass rescales its denominator but not
  its numerator sum e u when the running maximum grows;
- scal_deg_k: the statistics pass takes the degree as K everywhere (r
  wrong near the faces);
- scal_c_undiv: the statistics pass writes c undivided by the
  denominator;
- scal_drop_last: the statistics pass skips the stencil's last offset.

Each edit of csrc/stencil_attention_generic.cu names the kernel it
changes, the forward or the statistics pass; the ring header's edits
change every generic plane-ring kernel.

With --variant-b (variant B: 'in' norms, PReLU, dropout, AdamW with a
group, IntRegAffRefineLoss; its stacks on the unfused conv kernels) each
variant reads variant B's train gate (chip_smoke's `train variant b`
phases):

- sound: the tree as it is. Its run also reads the gate with two
  gradients of the kernel run replaced before the comparison (no
  kernel changes, so the same runs serve): slope_drop, ds_0's PReLU
  slope gradient lost (0); slope_70, that gradient at 70% of its value.
  Then a second witness of the slopes' rounding, at batch 4 (a float32
  step at batch 10 does not fit in 80 GB): the kernel step and the
  plain step, both in bf16, each against the plain step with float32
  activations, slope by slope;
- dw64: as above, the weight-gradient kernel skips every 64th K box.

With --entry (the network-entry conv's kernels, csrc/conv3x3x3_c1.cu)
each variant reads two gates: chip_smoke's conv sweep of that conv's
launches (the forward's raw + statistics, eval and raw modes and the
weight gradient at batch 2 against their plain versions, repeated
bitwise) and the flagship's train gate (fused stack). Variants:

- sound: the tree as it is;
- kd2: the forward drops the kd = 2 tap plane (its 9 taps read zero);
- st_row: the forward's statistics lose one block's row (block 1 writes
  zeros);
- dw_run: the weight gradient drops one split's run of K boxes (split 1
  adds nothing);
- edge: the forward's halo zero fill starts one column early at the
  volume's x edge (x = W - 1 reads zero).

With --dp (chip_smoke's train dp and train dp pad phases: two gloo ranks
on the card against the one-process step) each variant reads both
phases' gate, with broken lines of the port's data-parallel Python:

- sound: the tree as it is;
- stats_local: the bottleneck stack's second statistics (Co = 512) are
  not summed across the ranks (each rank normalises with its own);
- grad_sum: the gradients are summed across the ranks, not averaged
  (Adam is almost blind to the uniform factor 2: only the gradients
  show it);
- pad_weight1: mesh.pad_batch gives the padded row weight 1 (the
  reference keeps its own weight 0).

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
SAG = "stencil_attention_generic.cu"
SAB = "stencil_attention_generic_bwd.cu"
RING = "stencil_generic_ring.cuh"
# the generic forward and statistics pass (both in SAG): an edit names its
# kernel (tools/kernel_copies.py:make_copy)
FWD_K = "stencil_attention_generic_kernel"
SCAL_K = "stencil_attention_scal_generic_kernel"
EDGE_LOOP = ("        for (int k = st.start[d + sg::MAX_HALO];\n"
             "             k < st.start[d + sg::MAX_HALO + 1]; ++k) {")
DROP_LAST = EDGE_LOOP.replace(
    "k < st.start[d + sg::MAX_HALO + 1];",
    "k < min(st.start[d + sg::MAX_HALO + 1], st.k - 1);")
GENERIC_VARIANTS = {
    "sound": None,
    "dphi_plus": (SAB, "  const int sgn = -1;", "  const int sgn = 1;"),
    "fwd_drop_last": (SAG, EDGE_LOOP, DROP_LAST, FWD_K),
    "halo_stale": (RING, "    for (int pl = t.pz0; pl <= t.pz1; ++pl) "
                   "next(pl);", "    for (int pl = t.pz0; pl <= t.pz1; ++pl) "
                   "next(pl == t.pz0 && pl < t.za ? t.za : pl);"),
    "last_col": (RING, "  th.active = vi < p.yr * p.xr && th.y < t.yb && "
                 "th.x < t.xb;", "  th.active = vi < p.yr * p.xr && "
                 "th.y < t.yb && th.x < t.xb - 1;"),
    "no_rescale": (SAG, "          const float sc = __expf(m - mn);",
                   "          const float sc = 1.f;", FWD_K),
    "scal_num_stale": (SAG, "          num = fmaf(e, u, num * sc);",
                       "          num = fmaf(e, u, num);", SCAL_K),
    "scal_deg_k": (SAG, "      r = sg::rsqrt_degree(st, z, th.y, th.x, D, H, "
                   "W, h);", "      r = rsqrtf((float)st.k);", SCAL_K),
    "scal_c_undiv": (SAG, "make_float4(r, m, den, num / fmaxf(den, 1e-12f))",
                     "make_float4(r, m, den, num)", SCAL_K),
    "scal_drop_last": (SAG, EDGE_LOOP, DROP_LAST, SCAL_K),
}
VARIANT_B_VARIANTS = {"sound": None, "dw64": DW64}
C1 = "conv3x3x3_c1.cu"
ENTRY_VARIANTS = {
    "sound": None,
    "kd2": (C1, "        if (k < 27) kvalid |= 1u << (ks * 4 + c * 2 + e);",
            "        if (k < 18) kvalid |= 1u << (ks * 4 + c * 2 + e);"),
    "st_row": (C1, "      p.partials[static_cast<int64_t>(blockIdx.x) * 2 * "
               "p.Co + i] = tot;",
               "      p.partials[static_cast<int64_t>(blockIdx.x) * 2 * "
               "p.Co + i] = blockIdx.x == 1 ? 0.f : tot;"),
    "dw_run": (C1, "  const int nb = min(p.kboxes, p.nboxes - kb0);",
               "  const int nb = split == 1 ? 0 : min(p.kboxes, p.nboxes - "
               "kb0);"),
    "edge": (C1, "    if (e < C1_HALO && gx >= 0 && gx < p.W && gy >= 0 && "
             "gy < p.H &&",
             "    if (e < C1_HALO && gx >= 0 && gx < p.W - 1 && gy >= 0 && "
             "gy < p.H &&"),
}
DP_VARIANTS = {
    "sound": None,
    "stats_local": ("kernels/conv_stack.py",
                    "        bm1, bv1 = bn_batch_stats(st1, n, group)",
                    "        bm1, bv1 = bn_batch_stats(\n"
                    "            st1, n, None if w1.shape[0] == 512 else "
                    "group)"),
    "grad_sum": ("core/mesh.py", "    flat /= dist.get_world_size(group)",
                 "    flat /= 1"),
    "pad_weight1": ("core/mesh.py", "    weights[b:] = 0.0",
                    "    weights[b:] = 1.0"),
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


def read_entry():
    """Run in a copy's directory: chip_smoke's sweep of the network-entry
    conv's launches and the flagship's train gate of that copy, each
    printed with "pass" or its failure."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from dram_tpu_torch import weights
    from dram_tpu_torch.configs import st_dram_ref_att as settings
    from dram_tpu_torch.data.synth import train_batch
    from dram_tpu_torch.kernels import _build
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
    gate("kernel check entry conv sweep",
         lambda: cs.conv_sweep_phase(gen, cs.entry_launches()))
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


def read_generic():
    """Run in a copy's directory: chip_smoke's generic attention checks
    and variant A's train gate of that copy, each printed with "pass" or
    its failure."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from dram_tpu_torch.data.synth import train_batch
    from dram_tpu_torch.kernels import _build

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
    gate("kernel check generic attention",
         lambda: cs.generic_attention_phase(gen))
    torch.cuda.empty_cache()
    bench = os.path.join(ROOT, "assets", "bench_weights.ckpt.xz")
    va = cs.variant_a()
    batch = train_batch(cs.SEED, batch=va.TRAIN_BATCH_SIZE,
                        size=va.RESAMPLE_SIZE[0],
                        window=(va.WINDOWING_MIN, va.WINDOWING_MAX))

    def train_gate():
        k_run = cs.run_train(va, "generic kernels", batch, bench, True)
        torch.cuda.empty_cache()
        with cs.plain_versions():
            p_run = cs.run_train(va, "generic plain versions", batch, bench,
                                 True)
        cs.compare_train(k_run, p_run, cs.variant_buffers(va, bench)(),
                         "train generic")
    gate("train gate variant A", train_gate)


def read_variant_b(sound):
    """Run in a copy's directory: variant B's train gate of that copy,
    printed with "pass" or its failure; with `sound` also the gate's
    readings with ds_0's slope gradient lost or at 70% in the kernel run,
    and the float32 witness at batch 4."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from dram_tpu_torch.configs import with_settings
    from dram_tpu_torch.data.synth import train_batch
    from dram_tpu_torch.kernels import _build

    if not cs.__file__.startswith(os.getcwd()):
        raise SystemExit(f"imported {cs.__file__}, not the copy's")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    vb = cs.variant_b()

    def batch_of(settings):
        return train_batch(cs.SEED, batch=settings.TRAIN_BATCH_SIZE,
                           size=settings.RESAMPLE_SIZE[0],
                           window=(settings.WINDOWING_MIN,
                                   settings.WINDOWING_MAX))

    def gate(name, k_run, p_run):
        try:
            cs.compare_train(k_run, p_run, cs.variant_buffers(vb, None)(),
                             "train variant b")
            print(f"# {name}: pass", flush=True)
        except SystemExit as e:
            print(f"# {name}: {e}", flush=True)

    batch = batch_of(vb)
    k_run = cs.run_train(vb, "variant b kernels", batch, None)
    torch.cuda.empty_cache()
    with cs.plain_versions():
        p_run = cs.run_train(vb, "variant b plain versions", batch, None)
    torch.cuda.empty_cache()
    gate("train gate variant B", k_run, p_run)
    if not sound:
        return
    slope = "backbone.ds_0.convs.PReLU_0.negative_slope"
    for name, scale in (("slope_drop", 0.0), ("slope_70", 0.7)):
        print(f"# variant {name}: the kernel run's {slope} gradient times "
              f"{scale}", flush=True)
        grads = dict(k_run["grads"], **{slope: k_run["grads"][slope] * scale})
        gate(f"train gate variant B, {name}", dict(k_run, grads=grads),
             p_run)
    del k_run, p_run
    torch.cuda.empty_cache()

    w4 = with_settings(vb, TRAIN_BATCH_SIZE=4)
    batch = batch_of(w4)
    runs = {"kernels bf16": cs.run_train(w4, "witness kernels", batch, None)}
    torch.cuda.empty_cache()
    with cs.plain_versions():
        runs["plain bf16"] = cs.run_train(w4, "witness plain versions",
                                          batch, None)
        torch.cuda.empty_cache()
        f32 = cs.run_train(with_settings(w4, COMPUTE_DTYPE="float32"),
                           "witness plain versions f32", batch, None)
    torch.cuda.empty_cache()
    for n, want in f32["grads"].items():
        if not n.endswith("negative_slope"):
            continue
        errs = ", ".join(
            f"{tag} {r['grads'][n].item():.6g} (relative error "
            f"{abs(r['grads'][n].item() - want.item()) / abs(want.item()):.3g})"
            for tag, r in runs.items())
        print(f"# witness batch 4, {n}: float32 {want.item():.6g}; {errs}",
              flush=True)
    for tag, r in runs.items():
        rl2 = {n: ((r["grads"][n] - g).norm() / g.norm().clamp(min=1e-30))
               .item() for n, g in f32["grads"].items()
               if not cs.zero_in_exact_arithmetic(n)
               and not n.endswith("negative_slope")}
        worst = max(rl2, key=rl2.get)
        print(f"# witness batch 4, {tag} vs float32: worst relative L2 of "
              f"the other gradients {rl2[worst]:.3g} ({worst})", flush=True)


def read_dp():
    """Run in a copy's directory: chip_smoke's train dp and train dp pad
    gates of that copy, each printed with "pass" or its failure."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from dram_tpu_torch.kernels import _build

    if not cs.__file__.startswith(os.getcwd()):
        raise SystemExit(f"imported {cs.__file__}, not the copy's")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    cs.BENCH = os.path.join(ROOT, "assets", "bench_weights.ckpt.xz")

    def gate(ranks, ref, initial, label):
        try:
            cs.compare_dp(ranks, ref, initial, label)
            print(f"# gate {label}: pass", flush=True)
        except SystemExit as e:
            print(f"# gate {label}: {e}", flush=True)
    cs.train_dp_phases({}, gate)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="st_dram_ref",
                    choices=("st_dram_ref", "st_dram_ref_att"))
    ap.add_argument("--unfused", action="store_true",
                    help="st_dram_ref_att with USE_FUSED_STACK = False")
    ap.add_argument("--golden", action="store_true",
                    help="the kernel checks, the flagship's train gate and "
                    "the train golden gate of the upsample and dW variants")
    ap.add_argument("--generic", action="store_true",
                    help="the generic attention kernels' checks and variant "
                    "A's train gate of their variants")
    ap.add_argument("--variant-b", action="store_true",
                    help="variant B's train gate of the sound and dw64 "
                    "variants, the slope readings and the float32 witness")
    ap.add_argument("--entry", action="store_true",
                    help="the network-entry conv's sweep checks and the "
                    "flagship's train gate of the c1 kernels' variants")
    ap.add_argument("--dp", action="store_true",
                    help="the train dp and train dp pad gates of the sound "
                    "tree and of broken data-parallel code")
    ap.add_argument("--variants", help="comma-separated names to read "
                    "(default: all of the mode's)")
    args = ap.parse_args()
    if args.unfused and args.config != "st_dram_ref_att":
        raise SystemExit("--unfused goes with --config st_dram_ref_att")
    variants = ENTRY_VARIANTS if args.entry else DP_VARIANTS if args.dp \
        else VARIANT_B_VARIANTS \
        if args.variant_b \
        else GENERIC_VARIANTS if args.generic else GOLDEN_VARIANTS \
        if args.golden else UNFUSED_VARIANTS \
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
            read = ["--read-entry"] if args.entry else \
                ["--read-dp"] if args.dp else \
                ["--read-variant-b", str(int(change is None))] \
                if args.variant_b else ["--read-generic"] if args.generic \
                else ["--read-golden"] if args.golden \
                else ["--read", args.config, str(int(args.unfused))]
            rc = run_in_copy(d, __file__, read, LIMIT_S)
            if rc != 0:
                print(f"# variant {name} exited {rc}", flush=True)
                failed.append(name)
    if failed:
        raise SystemExit(f"variants that did not run to the end: {failed}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--read-entry"]:
        read_entry()
    elif sys.argv[1:2] == ["--read-dp"]:
        read_dp()
    elif sys.argv[1:2] == ["--read-variant-b"]:
        read_variant_b(sys.argv[2] == "1")
    elif sys.argv[1:2] == ["--read-generic"]:
        read_generic()
    elif sys.argv[1:2] == ["--read-golden"]:
        read_golden()
    elif sys.argv[1:2] == ["--read"]:
        read_gate(sys.argv[2], sys.argv[3] == "1")
    else:
        main()

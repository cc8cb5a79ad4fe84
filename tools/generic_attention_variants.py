#!/usr/bin/env python3
"""Times of the generic stencil-attention forward and gradient pass
(csrc/stencil_attention_generic.cu, csrc/stencil_attention_generic_bwd.cu)
at variant A's shapes (chip_smoke.VARIANT_A: k = 5, connectivity 2, self
loop, 98 offsets, F = 16, G = 4, all at 64^3: the forward at batch 10 for
a training step and 5 for a scan, the gradient pass at batch 10), for
variants of the source and of the tile plan, on one NVIDIA GPU.

    python3 tools/generic_attention_variants.py [--parent DIR] [--quick]
                                                [--variants a,b] [--step]

Each variant is a copy of the port made by tools/kernel_copies.py (the
checkout is never changed) that builds its own kernels:

- sound: the tree as it is;
- unroll1, unroll2: every edge loop unrolled by 1 or by 2 (the tree:
  the forward's by 1, the gradient pass's by 2; FWD_UNROLL, BWD_UNROLL);
- regs96, regs80: the launch bound at 320 threads and two blocks an SM
  (a thread's registers <= 96) or 256 threads and three (<= 80), with
  the plans' thread limit;
- fwd_noexp, fwd_samerow, fwd_nodz, fwd_noedges (timing only: the
  results are wrong): the forward without its exponentials, reading
  every edge from the voxel's own slot, without the offsets with dz !=
  0 (the planes still staged), without any edge (the ring, the centre
  rows and the stores only).

Per variant and launch also other tiles (planes, rows and columns a
tile), set counts and ring depths than the plan's (generic_fwd_plan /
generic_bwd_plan with `runs`, `sets`, `nbuf`), and the gradient pass's time
split into its +o and -o kernels (torch.profiler).

`--parent DIR` adds, first and last (parent, variants, parent), the
kernels of another commit's port unpacked in DIR (for example `git
archive <commit> dram_tpu_torch chip_smoke.py | tar -x -C DIR`), called
through its wrappers as they are. `--quick` reads the sound tree and the
parent only, parent / tree / tree / parent, without the tile sweep.
`--step` also runs variant A's three training steps (chip_smoke's
`train generic`, 10 x 80^3 from the trained backbone) with each
variant's kernels and prints each step's forward / backward ms.

Per launch a variant's result is held against the plain version (within
1e-4 of its largest value; inputs on a 1/8 grid, as in chip_smoke.py),
then timed (CUDA events around REPEAT launches back to back, median of 7
after a warm-up, per launch) beside its operations bound
(chip_smoke.generic_pass_work at 67 TFLOP/s f32).
"""

import argparse
import itertools
import os
import sys
import tempfile

from kernel_copies import ROOT, card_line, make_copy, run_in_copy

SAG = "stencil_attention_generic.cu"
RING = "stencil_generic_ring.cuh"
PY = "kernels/window_attention.py"
MAXT = "GENERIC_MAX_NBUF, GENERIC_BAR_BYTES, GENERIC_MAX_THREADS = 16, 256, 512"


def bounds(threads, blocks):
    """The kernels' launch bound at `threads` threads and `blocks` blocks
    an SM (a thread's registers <= 65536 / (threads x blocks)), and the
    plans' thread limit with it."""
    return [(RING, "constexpr int MAX_THREADS = 512;",
             f"constexpr int MAX_THREADS = {threads};"),
            (RING, "constexpr int MIN_BLOCKS = 1;",
             f"constexpr int MIN_BLOCKS = {blocks};"),
            (PY, MAXT, MAXT.replace("512", str(threads)))]


UNROLL = "constexpr int FWD_UNROLL = 1, BWD_UNROLL = 2;"
VARIANTS = {
    "sound": [],
    "unroll1": [(RING, UNROLL, UNROLL.replace("BWD_UNROLL = 2",
                                              "BWD_UNROLL = 1"))],
    "unroll2": [(RING, UNROLL, UNROLL.replace("FWD_UNROLL = 1",
                                              "FWD_UNROLL = 2"))],
    "regs96": bounds(320, 2),
    "regs80": bounds(256, 3),
    # timing only (the results are wrong): where the forward's time goes
    "fwd_noexp": [
        (SAG, "          const float sc = __expf(m - mn);",
         "          const float sc = 1.f;"),
        (SAG, "          const float e = ok ? __expf(l - mn) : 0.f;",
         "          const float e = ok ? l : 0.f;")],
    "fwd_samerow": [
        (SAG, "          const int idx = ok ? at + o.y * ncols + o.z : at;",
         "          const int idx = at;")],
    "fwd_nodz": [
        (SAG, "      if (!sg::step_reads(st, z, d, 1, D)) continue;",
         "      if (d != 0 || !sg::step_reads(st, z, d, 1, D)) continue;")],
    "fwd_noedges": [
        (SAG, "      if (th.active) {\n        if (inner)",
         "      if (false) {\n        if (inner)")],
}
# variants whose results are wrong: timed, not checked, not swept
TIMING_ONLY = {"fwd_noexp", "fwd_samerow", "fwd_nodz", "fwd_noedges"}
# (pass, batch) of variant A's generic launches, all at 64^3
LAUNCHES = [("fwd", 10), ("fwd", 5), ("bwd", 10)]
EDGE, F, G = 64, 16, 4
# (planes, rows, columns) and sets timed beside the plan's own
TILES = [(16, 8, 8), (32, 8, 8), (32, 4, 8), (16, 4, 16), (32, 4, 16),
         (16, 8, 16), (32, 8, 16)]
SETS = (3, 4, 6, 8)
# plane buffers beyond the 2h + sets + 1 the ring needs: planes the
# producer may stage ahead
EXTRA = (0, 2, 4)
REPEAT = 10
LIMIT_S = 900


def step_times():
    """Run in a copy's directory: chip_smoke's `train generic` steps with
    this copy's kernels (variant A from the trained backbone, 3 steps of
    10 x 80^3), each step's forward / backward / optimizer ms."""
    import chip_smoke as cs
    from dram_tpu_torch.data.synth import train_batch

    va = cs.variant_a()
    batch = train_batch(cs.SEED, batch=va.TRAIN_BATCH_SIZE,
                        size=va.RESAMPLE_SIZE[0],
                        window=(va.WINDOWING_MIN, va.WINDOWING_MAX))
    cs.run_train(va, "variant A", batch,
                 os.path.join(ROOT, "assets", "bench_weights.ckpt.xz"), True)


def measure(parent, sweep, timing_only=False, step=False):
    """Run in a copy's directory: the times of this copy's kernels."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from dram_tpu_torch.kernels import _build
    from dram_tpu_torch.kernels import window_attention as wa

    if not wa.__file__.startswith(os.getcwd()):
        raise SystemExit(f"imported {wa.__file__}, not the copy's")
    _build.load()
    if not parent:
        cs.ptxas_report(cs.GENERIC_KERNELS)
    offs = wa.stencil_offsets(*(cs.VARIANT_A[k] for k in (
        "at_k_size", "at_connectivity", "at_self_loop")))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for kind, B in LAUNCHES:
        def rnd(w):
            return torch.round(torch.randn(B, EDGE, EDGE, EDGE, w,
                                           generator=gen, device="cuda")
                               * 8) / 8
        th, ph, g, yb = rnd(F), rnd(F), rnd(G), rnd(G)
        if kind == "fwd":
            args = (th, ph, g, offs)
            fn, plain = wa.stencil_attention_generic, \
                wa.stencil_attention_plain
        else:
            args = (th, ph, g, yb,
                    wa.stencil_attention_scal_plain(th, ph, g, yb, offs),
                    offs)
            fn, plain = wa.stencil_attention_bwd_generic, \
                wa.stencil_attention_bwd_plain
        edges = B * int(wa.valid_masks((EDGE,) * 3, offs).sum())
        nb, ops = cs.generic_pass_work(kind, F, G, B * EDGE ** 3, edges)
        bound_ms, _ = cs.bound(nb, ops, cs.F32_FLOPS)
        with torch.no_grad():
            want = plain(*args)
            want = want if isinstance(want, tuple) else (want,)
            got = fn(*args)
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            err = max((a - b).abs().max().item() / b.abs().max().item()
                      for a, b in zip(got, want))
            del got
            ms = cs.cuda_ms(lambda: [fn(*args) for _ in range(REPEAT)]) \
                / REPEAT
        note = "timing only" if timing_only else \
            f"{'ok' if err <= 1e-4 else 'DISAGREES'} (err {err:.3g} of " \
            "the largest)"
        print(f"# {kind} {B}x{EDGE}^3: ms {ms:.4f} ({100 * bound_ms / ms:.1f}"
              f"% of the bound {bound_ms:.4f}); {note}", flush=True)
        if not parent and kind == "bwd":
            split(fn, args)
        if not parent and sweep:
            tiles(wa, cs, kind, B, args, want, bound_ms)
        del th, ph, g, yb, args, want
        torch.cuda.empty_cache()
    if step:
        step_times()


def split(fn, args):
    """The gradient pass's device time by kernel (+o and -o side)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPEAT):
            fn(*args)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if "bwd_plus" in e.key or "bwd_minus" in e.key:
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = getattr(e, "cuda_time_total", 0.0)
            side = "+o" if "plus" in e.key else "-o"
            print(f"#   bwd {side} side: {t / 1e3 / REPEAT:.4f} ms a launch "
                  f"(profiler, {e.count} launches)", flush=True)


def tiles(wa, cs, kind, B, args, want, bound_ms):
    """The launch with other tiles and set counts, each held against the
    plain version."""
    import torch

    from dram_tpu_torch.kernels import _build

    h = wa.generic_halo(args[-1])
    offs, K = wa._offsets_arg(args[-1])
    outs = tuple(torch.empty_like(w) for w in want)
    ptrs = [t.data_ptr() for t in args[:-1] + outs]
    entry = "stencil_attention_generic_f32" if kind == "fwd" \
        else "stencil_attention_bwd_generic_f32"
    plan_of = wa.generic_fwd_plan if kind == "fwd" else wa.generic_bwd_plan
    seen = set()
    for runs, sets, extra in itertools.product(TILES, SETS, EXTRA):
        try:
            p = plan_of(B, EDGE, EDGE, EDGE, F, G, h, runs=runs,
                        sets=sets, nbuf=2 * h + sets + 1 + extra)
        except ValueError:
            continue
        if p["args"] in seen:
            continue
        seen.add(p["args"])

        def launch():
            _build.launch(entry, *ptrs, B, EDGE, EDGE, EDGE, F, G, offs,
                          K, wa._args(p["args"]))
        launch()
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() / b.abs().max().item()
                  for a, b in zip(outs, want))
        ms = cs.cuda_ms(lambda: [launch() for _ in range(REPEAT)]) \
            / REPEAT
        smem = p["smem"] if kind == "fwd" else \
            (p["plus"]["smem"], p["minus"]["smem"])
        print(f"#   {kind} {B}x{EDGE}^3 tile {runs} sets {sets} nbuf "
              f"+{extra}: smem "
              f"{smem}; ms {ms:.4f} ({100 * bound_ms / ms:.1f}%); "
              f"{'ok' if err <= 1e-4 else 'DISAGREES'} (err {err:.3g})",
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an unpacked port of another commit")
    ap.add_argument("--quick", action="store_true",
                    help="the sound tree (and the parent) without the sweep")
    ap.add_argument("--variants", help="comma-separated names to read "
                    "(default: all)")
    ap.add_argument("--step", action="store_true",
                    help="also variant A's training steps (chip_smoke's "
                    "train generic) with each variant's kernels")
    args = ap.parse_args()
    print(card_line(), flush=True)
    names = ["sound"] if args.quick else \
        args.variants.split(",") if args.variants else list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    runs = [(name, VARIANTS[name], None) for name in names]
    if args.parent:
        par = ("parent", [], os.path.abspath(args.parent))
        # parent, tree, tree, parent with --quick
        runs = [par] + runs * (2 if args.quick else 1) + [par]
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        for k, (name, edits, root) in enumerate(runs):
            d = make_copy(tmp, f"{name}{k}", edits,
                          **({"root": root} if root else {}))
            print(f"# variant {name}", flush=True)
            flags = ["--measure", str(int(root is not None)),
                     str(int(not args.quick and name not in TIMING_ONLY)),
                     str(int(name in TIMING_ONLY)), str(int(args.step))]
            if run_in_copy(d, __file__, flags, LIMIT_S) != 0:
                failed.append(name)
    if failed:
        raise SystemExit(f"variants that did not run to the end: {failed}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--measure"]:
        measure(*(a == "1" for a in sys.argv[2:6]))
    else:
        main()

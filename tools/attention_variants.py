#!/usr/bin/env python3
"""Times of the stencil-attention kernels (csrc/stencil_attention.cu) at
every attention launch of the flagship (the forward at batch 5 for a
scan, 10 for a training step and 2 for the training golden; the
statistics and gradient passes at batch 10 and 2; all at 64^3, F = G =
8, f32), for variants of the source and of the tile plan, on one NVIDIA
GPU.

    python3 tools/attention_variants.py [--parent DIR]

Each variant is a copy of the port made by tools/kernel_copies.py (the
checkout is never changed) that builds its own kernels. `--parent` adds
the variants of another commit's port, unpacked in DIR (for example
`git archive <commit> dram_tpu_torch chip_smoke.py | tar -x -C DIR` of a
commit with the one-thread-per-voxel kernels):

- per_voxel: that commit's kernels as they are;
- per_voxel_nodz: its forward and gradient pass skip the ten offsets with
  dz != 0 (timing only: the results are wrong). If the neighbours a
  plane away, which other blocks hold and L2 serves, are what those
  kernels pay for, this variant takes less than half their time.

The checkout's variants (the plane-ring forward and gradient pass):

- sound: the tree as it is; per launch of the forward and the gradient
  pass also other tiles (rows and columns per tile, planes per run) and
  ring depths than the plan's (fwd_plan / bwd_plan with `runs`, `nbuf`);
- nodz: the forward and the gradient pass skip the ten offsets with
  dz != 0 (timing only): what the neighbours a plane away still cost
  once they come from shared memory;
- fast_exp: __expf (ex2.approx) in place of expf in both kernels;
- bwd_unroll1, bwd_unroll3: the gradient pass's neighbour loops unrolled
  by 1 or 3 instead of BWD_UNROLL = 2.

Per launch a variant's result is held against the plain version (within
1e-4 of its largest value; inputs on a 1/8 grid, as in chip_smoke.py)
unless the variant is timing only, then timed (CUDA events around REPEAT
launches back to back, median of 7 after a warm-up, per launch) beside
the byte bound (each input read once, each output written once, at 3.35
TB/s).
"""

import argparse
import os
import sys
import tempfile

from kernel_copies import card_line, make_copy, run_in_copy

SA = "stencil_attention.cu"
# variant -> (edits, timing only)
VARIANTS = {
    "sound": ([], False),
    "nodz": ([
        (SA, "      ok[n] = active && (half ? ok1 : ok0);",
         "      ok[n] = active && !dz && (half ? ok1 : ok0);"),
        (SA, "        valid |= (uint32_t)ok << n++;",
         "        valid |= (uint32_t)(ok && !dz) << n++;")], True),
    "fast_exp": ([
        (SA, "        const float ex = expf(sl[n] - m);",
         "        const float ex = __expf(sl[n] - m);"),
        (SA, "          const float a = expf(fmaxf(s, 0.f) * rv - mv) * inv;",
         "          const float a = __expf(fmaxf(s, 0.f) * rv - mv) * inv;"),
        (SA, "          const float a2 = __fdividef(expf(",
         "          const float a2 = __fdividef(__expf(")], False),
    "bwd_unroll1": ([
        (SA, "constexpr int BWD_UNROLL = 2;", "constexpr int BWD_UNROLL = 1;")],
        False),
    "bwd_unroll3": ([
        (SA, "constexpr int BWD_UNROLL = 2;", "constexpr int BWD_UNROLL = 3;")],
        False),
}
# (ZR, YR, XR) tiles and ring depths timed beside the plan's own: tiles
# of 64 to 256 voxels a plane (more blocks an SM the smaller they are)
TILES = [(z, y, x) for y, x in ((1, 64), (2, 32), (4, 16), (3, 32), (6, 16),
                                (2, 64), (4, 32), (8, 16)) for z in (8, 16, 32)]
DEPTHS = (None, 6)
# launches timed back to back: the time per launch then leaves out the
# Python wrapper's host time, which the device would otherwise wait for
REPEAT = 10
PARENT_VARIANTS = {
    "per_voxel": ([], False),
    "per_voxel_nodz": ([
        (SA, "      const int64_t j = i + (dz * H + dy) * W + dx;\n"
             "      float ph[F], gj[G];\n"
             "      load8(phi + j * F, ph);\n"
             "      load8(g + j * G, gj);\n"
             "      const float s = fmaxf(dot8(th, ph), 0.f) * rs;\n"
             "      if (s > m) {",
         "      if (dz) continue;\n"
         "      const int64_t j = i + (dz * H + dy) * W + dx;\n"
         "      float ph[F], gj[G];\n"
         "      load8(phi + j * F, ph);\n"
         "      load8(g + j * G, gj);\n"
         "      const float s = fmaxf(dot8(th, ph), 0.f) * rs;\n"
         "      if (s > m) {"),
        (SA, "      const int64_t off = (dz * H + dy) * W + dx;",
         "      if (dz) continue;\n"
         "      const int64_t off = (dz * H + dy) * W + dx;")], True),
}
# (pass, batch) of every attention launch of the flagship's paths
LAUNCHES = [("fwd", 5), ("fwd", 10), ("fwd", 2), ("scal", 10), ("scal", 2),
            ("bwd", 10), ("bwd", 2)]
EDGE = 64
# bytes a voxel moves through device memory, each input read once and
# each output written once: theta, phi, g in and out (forward); those,
# ybar in and 4 statistics out (statistics); those with the statistics in
# and three gradients out (gradient pass)
VOXEL_BYTES = {"fwd": 4 * 32, "scal": 4 * 32 + 16, "bwd": 4 * 32 + 16 + 96}
LIMIT_S = 600


def measure(timing_only):
    """Run in a copy's directory: the times of this copy's kernels."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from dram_tpu_torch.kernels import _build
    from dram_tpu_torch.kernels import window_attention as wa

    if not wa.__file__.startswith(os.getcwd()):
        raise SystemExit(f"imported {wa.__file__}, not the copy's")
    _build.load()
    if hasattr(cs, "ptxas_report"):
        cs.ptxas_report(cs.ATTENTION_RING_KERNELS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for kind, B in LAUNCHES:
        shape = (B, EDGE, EDGE, EDGE, 8)
        th, ph, g, yb = (torch.round(torch.randn(
            *shape, generator=gen, device="cuda") * 8) / 8 for _ in range(4))
        args = {"fwd": (th, ph, g), "scal": (th, ph, g, yb)}.get(kind)
        if kind == "bwd":
            args = (th, ph, g, yb, wa.stencil_attention_scal_plain(
                th, ph, g, yb))
        fn, plain = {"fwd": (wa.stencil_attention, wa.stencil_attention_plain),
                     "scal": (wa.stencil_attention_scal,
                              wa.stencil_attention_scal_plain),
                     "bwd": (wa.stencil_attention_bwd,
                             wa.stencil_attention_bwd_plain)}[kind]
        with torch.no_grad():
            note = "timing only"
            if not timing_only:
                got, want = fn(*args), plain(*args)
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                torch.cuda.synchronize()
                err = max((a - b).abs().max().item() / max(
                    b.abs().max().item(), 1e-30) for a, b in zip(got, want))
                note = f"{'ok' if err <= 1e-4 else 'DISAGREES'} " \
                    f"(err {err:.3g} of the largest)"
                del got, want
            ms = cs.cuda_ms(lambda: [fn(*args) for _ in range(REPEAT)]) \
                / REPEAT
        bound_ms = B * EDGE ** 3 * VOXEL_BYTES[kind] / cs.HBM_BPS * 1e3
        print(f"# {kind} {B}x{EDGE}^3: ms {ms:.4f} ({100 * bound_ms / ms:.1f}"
              f"% of the bound {bound_ms:.4f}); {note}", flush=True)
        if kind != "scal" and hasattr(wa, "fwd_plan") and not timing_only:
            tiles(wa, cs, kind, B, args, plain, bound_ms)
        del th, ph, g, yb, args
        torch.cuda.empty_cache()


def tiles(wa, cs, kind, B, args, plain, bound_ms):
    """The launch with the plan's tile at other ring depths and with
    other tiles (TILES, DEPTHS), each held against the plain version."""
    import torch

    from dram_tpu_torch.kernels import _build

    plan_of = wa.fwd_plan if kind == "fwd" else wa.bwd_plan
    own = plan_of(B, EDGE, EDGE, EDGE)
    want = plain(*args)
    want = want if isinstance(want, tuple) else (want,)
    outs = tuple(torch.empty_like(w) for w in want)
    ptrs = [t.data_ptr() for t in args + outs]
    entry = "stencil_attention_f32" if kind == "fwd" \
        else "stencil_attention_bwd_f32"
    variants = [(own["run"], d) for d in DEPTHS] + [
        (r, None) for r in TILES if r != own["run"]]
    seen = set()
    for runs, nbuf in variants:
        try:
            p = plan_of(B, EDGE, EDGE, EDGE, runs=runs, nbuf=nbuf)
        except ValueError:
            continue
        if p["args"] in seen:
            continue
        seen.add(p["args"])

        def launch():
            _build.launch(entry, *ptrs, B, EDGE, EDGE, EDGE,
                          wa._args(p["args"]))
        launch()
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() / b.abs().max().item()
                  for a, b in zip(outs, want))
        ms = cs.cuda_ms(lambda: [launch() for _ in range(REPEAT)]) / REPEAT
        print(f"#   {kind} {B}x{EDGE}^3 tile {runs} nbuf {p['nbuf']}: "
              f"{p['blocks']} blocks, {p['smem']} B smem; ms {ms:.4f} "
              f"({100 * bound_ms / ms:.1f}%); "
              f"{'ok' if err <= 1e-4 else 'DISAGREES'} (err {err:.3g})",
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an unpacked port of another commit")
    args = ap.parse_args()
    print(card_line(), flush=True)
    runs = []
    if args.parent:
        runs += [(name, edits, only, os.path.abspath(args.parent))
                 for name, (edits, only) in PARENT_VARIANTS.items()]
    runs += [(name, edits, only, None)
             for name, (edits, only) in VARIANTS.items()]
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, edits, only, root in runs:
            d = make_copy(tmp, name, edits, **({"root": root} if root
                                               else {}))
            print(f"# variant {name}{' (timing only)' if only else ''}",
                  flush=True)
            if run_in_copy(d, __file__, ["--measure", str(int(only))],
                           LIMIT_S) != 0:
                failed.append(name)
    if failed:
        raise SystemExit(f"variants that did not run to the end: {failed}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--measure"]:
        measure(sys.argv[2] == "1")
    else:
        main()

#!/usr/bin/env python3
"""Times of csrc/upsample2x.cu's two kernels at every upsample launch of
the flagship (the scan's forwards at batch 5, the step's forwards and
adjoints at batch 10), for variants of the source and of the tile plan,
on one NVIDIA GPU.

    python3 tools/upsample_variants.py [--top 6]

Each variant is a copy of the port made by tools/kernel_copies.py (the
checkout is never changed) that builds its own kernels:

- sound: the tree as it is;
- fwd512: the forward's launch bound raised to 512 threads, two blocks
  an SM (64 registers a thread instead of 128), in the .cu and in the
  plan (kernels/upsample.py: FWD_THREADS).

In each copy, per launch, the plan's own tile (fwd_plan / bwd_plan) and
the `--top` best other tiles by the plan's score are held against the
plain version (2^-7 of the largest value) and timed (CUDA events, median
of 7 after a warm-up).
"""

import argparse
import os
import sys
import tempfile

from kernel_copies import card_line, make_copy, run_in_copy

VARIANTS = {
    "sound": [],
    "fwd512": [
        ("upsample2x.cu",
         "constexpr int FWD_THREADS = 256, BWD_THREADS = 256;",
         "constexpr int FWD_THREADS = 512, BWD_THREADS = 256;"),
        ("kernels/upsample.py",
         "SMEM_BUDGET, FWD_THREADS, BWD_THREADS = 113 * 1024, 256, 256",
         "SMEM_BUDGET, FWD_THREADS, BWD_THREADS = 113 * 1024, 512, 256")],
}
LIMIT_S = 600


def candidates(up, B, n, C, bwd, top):
    """The plan's tile and the `top` best others by the plan's score."""
    plan = (up.bwd_plan if bwd else up.fwd_plan)(B, n, n, n, C)
    sx = up.BWD_SX if bwd else up.FWD_SX
    most = up.BWD_THREADS if bwd else up.FWD_THREADS
    ext = n if bwd else 2 * n
    written = B * n ** 3 * C * 2 * (1 if bwd else 8)
    scored = []
    for yr in (1, 2, 4, 8, 16):
        for xr in sorted({min(ext, sx * k) for k in range(1, 11)}):
            for zr in sorted({min(ext, z) for z in (2, 4, 8, 16, 24, 40, 80,
                                                    160)}):
                try:
                    p = (up.bwd_plan if bwd else up.fwd_plan)(
                        B, n, n, n, C, runs=(zr, yr, xr))
                except ValueError:
                    continue
                if p["threads"] > most or p["threads"] < 64 \
                        or p["smem"] > up.SMEM_BUDGET \
                        or p["run"] == plan["run"]:
                    continue
                score = (p["staged_bytes"] + written) \
                    * max(1.0, up.WAVES * 2 * up.SMS / p["blocks"])
                scored.append((score, p["run"]))
    return [plan["run"]] + [r for _, r in sorted(set(scored))[:top]]


def measure(top):
    """Run in a copy's directory: the table of this copy's kernels."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from dram_tpu_torch.kernels import _build
    from dram_tpu_torch.kernels import upsample as up

    if not up.__file__.startswith(os.getcwd()):
        raise SystemExit(f"imported {up.__file__}, not the copy's")
    _build.load()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for kind, lv, B, e, C in cs.upsample_launches():
        if B == 2:
            continue
        bwd = kind == "bwd"
        shape = (B, 2 * e, 2 * e, 2 * e, C) if bwd else (B, e, e, e, C)
        x = torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        want = (up.upsample2x_bwd_plain if bwd else up.upsample2x_plain)(x)
        out = torch.empty_like(want)
        entry = "upsample2x_bwd_bf16" if bwd else "upsample2x_bf16"
        bound_ms, _ = cs.bound(cs.nbytes(x, want), 0.0, cs.F32_FLOPS)
        for k, runs in enumerate(candidates(up, B, e, C, bwd, top)):
            p = (up.bwd_plan if bwd else up.fwd_plan)(B, e, e, e, C,
                                                      runs=runs)

            def launch():
                _build.launch(entry, x.data_ptr(), out.data_ptr(), B, e, e,
                              e, C, up._args(p["args"]))
            launch()
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            ok = err <= 2 ** -7 * want.float().abs().max().item()
            ms = cs.cuda_ms(launch)
            print(f"# {kind} {lv} {B}x{e}^3x{C} runs {runs}"
                  f"{' (plan)' if k == 0 else ''}: {p['threads']} threads, "
                  f"{p['smem']} B smem, {p['blocks']} blocks; ms {ms:.4f} "
                  f"({100 * bound_ms / ms:.1f}% of the bound "
                  f"{bound_ms:.4f}); {'ok' if ok else 'DISAGREES'} "
                  f"(err {err:.3g})", flush=True)
        del x, want, out
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args()
    print(card_line(), flush=True)
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, edits in VARIANTS.items():
            d = make_copy(tmp, name, edits)
            print(f"# variant {name}", flush=True)
            rc = run_in_copy(d, __file__, ["--measure", str(args.top)],
                             LIMIT_S)
            if rc != 0:
                failed.append(name)
    if failed:
        raise SystemExit(f"variants that did not run to the end: {failed}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--measure"]:
        measure(int(sys.argv[2]))
    else:
        main()

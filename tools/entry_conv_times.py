#!/usr/bin/env python3
"""Times of the network-entry conv's launches on one NVIDIA GPU, in this
checkout and, with --parent, in another one.

    python3 tools/entry_conv_times.py [--parent DIR]

The entry conv (ds_0.conv_0, 1 -> 32 channels) runs in four launches on
the flagship's paths: the scan's eval forward (batch 5 x 80^3), the fused
step's raw + statistics forward and its weight gradient, and the unfused
step's raw forward (batch 10 x 80^3). Each is called through the wrapper
a path calls (conv_stack.conv3x3x3, conv3x3x3_train, conv3x3x3_dw,
conv3d.conv3d), so a checkout routes it as it does: this tree to
csrc/conv3x3x3_c1.cu, an earlier one to its own kernels. Each launch is
timed by CUDA events, per call over 10 calls back to back (median of 7),
beside cuDNN's call for the same conv and the launch's byte bound. With
--parent DIR (a `git archive` of another commit unpacked in a git-ignored
directory such as .verify_cache/parent, with its own dram_tpu_torch/) the
runs alternate: parent, tree, tree, parent, each in its own process.
"""

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BPS = 3.35e12  # H100 SXM HBM3 (chip_smoke.HBM_BPS)
REPEAT = 10


def read(label):
    """Run with the checkout to time as the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    import torch.nn.functional as F

    from dram_tpu_torch.kernels import _build, conv3d, conv_stack

    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(7):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            for _ in range(REPEAT):
                fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / REPEAT)
        return sorted(times)[3]

    w = torch.randn(32, 1, 3, 3, 3, generator=gen, device="cuda") * 0.2
    wl = w.to(torch.bfloat16)
    s = torch.rand(32, generator=gen, device="cuda") + 0.5
    t = torch.randn(32, generator=gen, device="cuda") * 0.1
    for mode, B in (("eval", 5), ("raw+stats", 10), ("raw", 10),
                    ("dw", 10)):
        x = torch.randn(B, 80, 80, 80, 1, generator=gen,
                        device="cuda").to(torch.bfloat16)
        xl = x.permute(0, 4, 1, 2, 3)
        dy = torch.randn(B, 80, 80, 80, 32, generator=gen,
                         device="cuda").to(torch.bfloat16) \
            if mode == "dw" else None
        fn = {"eval": lambda: conv_stack.conv3x3x3(x, w, s, t),
              "raw+stats": lambda: conv_stack.conv3x3x3_train(x, w,
                                                              stats=True),
              "raw": lambda: conv3d.conv3d(x, w),
              "dw": lambda: conv_stack.conv3x3x3_dw(x, dy)}[mode]
        lib = (lambda: torch.nn.grad.conv3d_weight(
            xl, (32, 1, 3, 3, 3), dy.permute(0, 4, 1, 2, 3), padding=1)) \
            if mode == "dw" else (lambda: F.conv3d(xl, wl, padding=1))
        with torch.no_grad():
            ms, lib_ms = per_call(fn), per_call(lib)
        bound = B * 80 ** 3 * (2 + 64) / HBM_BPS * 1e3
        print(f"# [{label}] entry conv {mode} {B}x80^3: ms {ms:.4f}, cuDNN "
              f"{lib_ms:.4f}, byte bound {bound:.4f} ({100 * bound / ms:.1f}"
              f"% of it); per call over {REPEAT} back to back", flush=True)
        del x, xl, dy
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another checkout to time in turn")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=20)
    print(smi.stdout.strip(), flush=True)
    runs = [("tree", ROOT)]
    if args.parent:
        parent = os.path.abspath(args.parent)
        runs = [("parent", parent), ("tree", ROOT), ("tree", ROOT),
                ("parent", parent)]
    for label, root in runs:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--read", label], cwd=root, timeout=600).returncode
        if rc != 0:
            raise SystemExit(f"the {label} run exited {rc}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--read"]:
        read(sys.argv[2])
    else:
        main()

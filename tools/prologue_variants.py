#!/usr/bin/env python3
"""What the BatchNorm prologue of the Hopper conv kernels costs, on one
NVIDIA GPU.

    python3 tools/prologue_variants.py

For each variant the script copies dram_tpu_torch/ into a temporary
directory with one line of a CUDA source edited there
(tools/kernel_copies.py; the checkout is never changed), and in that copy
builds the kernels and times, at the flagship's us_2 conv_1 shape (10 x
80^3, 64 -> 64, bf16), the conv's raw-output + statistics mode against
its prologue + statistics mode, and the weight gradient without and with
the prologue (CUDA events, median of 5 after one warm-up):

- sound: the sources as they are;
- no_fence: the prologue threads skip fence.proxy.async before they
  signal the halo ready (unsafe; timing only);
- no_transform: the prologue returns at once (wrong results; it leaves
  the waits on the ready barriers and the rest of the pipeline);
- dw_4_stages: the weight-gradient kernel keeps 4 stages instead of 3.
"""

import os
import sys
import tempfile

import torch

from kernel_copies import card_line, make_copy, run_in_copy

FENCE = ("            wg::fence_async_smem();\n"
         "            wg::mbar_arrive(&a_ready[sa]);")
DW_FENCE = ("        wg::fence_async_smem();\n"
            "        wg::mbar_arrive(&ready[s]);")
START = ("  const int g = tid & 7, step = nthreads >> 3;\n"
         "  const bool cok = g * 8 < cvalid;")
VARIANTS = {
    "sound": [],
    "no_fence": [("conv3x3x3.cu", FENCE,
                  "            wg::mbar_arrive(&a_ready[sa]);"),
                 ("conv3x3x3_dw.cu", DW_FENCE,
                  "        wg::mbar_arrive(&ready[s]);")],
    "no_transform": [("conv_wgmma.cuh", START,
                      START + "\n  if (step > 0) return;")],
    "dw_4_stages": [("conv3x3x3_dw.cu", "constexpr int DW_NS = 3;",
                     "constexpr int DW_NS = 4;")],
}


def cuda_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def read_times(name):
    """Run in a copy's directory: builds the copy's kernels and prints
    its times."""
    sys.path.insert(0, os.getcwd())
    from dram_tpu_torch.kernels import _build, conv_stack as cs

    if not cs.__file__.startswith(os.getcwd()):
        raise SystemExit(f"imported {cs.__file__}, not the copy's")
    _build.load()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.relu(torch.randn(10, 80, 80, 80, 64, generator=g,
                               device="cuda")).bfloat16()
    dy = torch.randn(10, 80, 80, 80, 64, generator=g,
                     device="cuda").bfloat16()
    w = torch.randn(64, 64, 3, 3, 3, generator=g, device="cuda") * 0.05
    pro = (torch.rand(64, generator=g, device="cuda") + 0.5,
           torch.randn(64, generator=g, device="cuda") * 0.3)
    raw = cuda_ms(lambda: cs.conv3x3x3_train(x, w, stats=True))
    fwd = cuda_ms(lambda: cs.conv3x3x3_train(x, w, prologue=pro,
                                             stats=True))
    dw_raw = cuda_ms(lambda: cs.conv3x3x3_dw(x, dy))
    dw = cuda_ms(lambda: cs.conv3x3x3_dw(x, dy, prologue=pro))
    print(f"# {name}: conv raw + statistics {raw:.3f} ms, prologue "
          f"+ statistics {fwd:.3f} ms ({fwd / raw:.2f}x); dW "
          f"{dw_raw:.3f} ms, with the prologue {dw:.3f} ms "
          f"({dw / dw_raw:.2f}x)", flush=True)


def main():
    print(card_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for name, edits in VARIANTS.items():
            d = make_copy(tmp, name, edits)
            rc = run_in_copy(d, __file__, ["--read", name], 300)
            if rc != 0:
                raise SystemExit(f"variant {name} exited {rc}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--read"]:
        read_times(sys.argv[2])
    else:
        main()

#!/usr/bin/env python3
"""Where the time of the PyTorch port's training step goes on one GPU.

    python3 tools/profile_torch_train.py [--config st_dram_ref_att]
                                         [--unfused] [--warm 2]
                                         [--trace PATH]

Builds the step as chip_smoke.py's train phases do (st_dram_ref: DC3D at
the published widths from the trained flagship's backbone; st_dram_ref_att:
the flagship DC3DATGeneric from its whole trained tree; --unfused sets
USE_FUSED_STACK = False, the unfused conv stack; bf16, one
synthetic batch of 10 x 80^3 chunks from seed 0 in the config's window),
takes `--warm` steps, then one step under
torch.profiler with CPU and CUDA activities. Prints the step's stage
split (CUDA events), its device time by kernel (the port's CUDA kernels
by name, PyTorch's own kernels grouped), the device's busy share of the
step (union of kernel intervals over the step's span on the device) and,
with --trace, writes the Chrome trace. Needs a CUDA device.
"""

import argparse
import importlib
import os
import sys

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dram_tpu_torch.configs import with_settings  # noqa: E402
from dram_tpu_torch.data.synth import train_batch  # noqa: E402
from dram_tpu_torch.train.trainer import (batch_tensors,  # noqa: E402
                                          build_train_step)

# the port's kernels (csrc/*.cu) by their __global__ names
PORT_KERNELS = ("conv3x3x3_kernel", "conv3x3x3_dw_kernel", "colsum_kernel",
                "maxpool2_kernel", "maxpool2_bwd_kernel",
                "upsample2x_kernel", "upsample2x_bwd_kernel",
                "stencil_attention_kernel", "stencil_attention_scal_kernel",
                "stencil_attention_bwd_kernel")


def group_of(name):
    for k in PORT_KERNELS:
        if k in name:
            return "port " + k
    low = name.lower()
    if "adam" in low or "multi_tensor" in low:
        return "torch optimizer (Adam)"
    if "gemm" in low or "gemv" in low or "xmma" in low:
        return "torch matmul (1x1x1 top layer and tap heads, resize, PCM)"
    if "reduce" in low:
        return "torch reductions (BN statistics and backward sums, losses)"
    if "copy" in low or "cat" in low:
        return "torch copies / casts"
    return "torch elementwise (BN affine / backward, losses, grad adds)"


def union_us(intervals):
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="st_dram_ref",
                    choices=("st_dram_ref", "st_dram_ref_att"))
    ap.add_argument("--unfused", action="store_true",
                    help="USE_FUSED_STACK = False (the unfused conv stack)")
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: needs a CUDA device")
    print(f"{torch.cuda.get_device_name(0)}: {args.config}"
          f"{' unfused' if args.unfused else ''}", flush=True)
    settings = importlib.import_module(
        f"dram_tpu_torch.configs.{args.config}")
    if args.unfused:
        settings = with_settings(settings, USE_FUSED_STACK=False)
    step = build_train_step(
        settings, "cuda",
        os.path.join(ROOT, "assets", "bench_weights.ckpt.xz"))
    batch = batch_tensors(train_batch(
        0, settings.TRAIN_BATCH_SIZE, settings.RESAMPLE_SIZE[0],
        (settings.WINDOWING_MIN, settings.WINDOWING_MAX)),
        torch.device("cuda"), "u16")
    for _ in range(args.warm):
        step(**batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r = step(**batch)
        torch.cuda.synchronize()
    ms = r["ms"]
    step_ms = sum(ms.values())
    print(f"# step: forward {ms['forward']:.1f} ms backward "
          f"{ms['backward']:.1f} ms optimizer {ms['optimizer']:.1f} ms, "
          f"total {step_ms:.1f} ms (CUDA events); peak "
          f"{r['peak_mib']:.0f} MiB", flush=True)

    # device activity, without the annotations PyTorch draws on the
    # device timeline around regions such as Optimizer.step
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise SystemExit("profile_torch_train: the profiler recorded no "
                         "device activity")
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy = union_us(spans) / 1e3
    span = (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e3
    by_name, by_group = {}, {}
    for e in kernels:
        d = (e.time_range.end - e.time_range.start) / 1e3
        n, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (n + d, c + 1)
        g = group_of(e.name)
        gn, gc = by_group.get(g, (0.0, 0))
        by_group[g] = (gn + d, gc + 1)
    print(f"# device: {len(kernels)} kernels, busy {busy:.1f} ms of a "
          f"{span:.1f} ms span on the device ({100 * busy / span:.1f}% "
          f"busy, {100 * (1 - busy / span):.1f}% idle)", flush=True)
    print("# device time by group (ms, launches, share of busy):")
    for g, (t, c) in sorted(by_group.items(), key=lambda kv: -kv[1][0]):
        print(f"#   {t:9.2f} {c:6d} {100 * t / busy:5.1f}%  {g}")
    print("# device time by kernel, top 25 (ms, launches):")
    for n, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"#   {t:9.2f} {c:6d}  {n[:110]}")
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)
        print(f"# trace: {args.trace}")


if __name__ == "__main__":
    main()

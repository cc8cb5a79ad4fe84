#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dram_tpu_torch) once on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each under a faulthandler watchdog that ends a hung run with a
traceback and a non-zero exit:

1. card: the card's name and power limit (nvidia-smi); fails without CUDA.
2. build: nvcc builds the four CUDA kernels from dram_tpu_torch/kernels/csrc.
3. one phase per kernel, at the main path's largest shape: the kernel
   against its plain PyTorch version on the same inputs (error against the
   stated tolerance), then CUDA-event times (median of 7 after warm-up) of
   the kernel, the plain version and, where one PyTorch call computes the
   same function, that call (timed here only; the port never calls it).
4. pipeline: the trained flagship DC3DATGeneric (assets/bench_weights.ckpt.xz)
   at full width on a synthetic 160x192x192 scan at anisotropic spacing:
   host prep, then process_chunks with the kernels for want_heatmap False
   and True, with every launch count set to 0 just before and read just
   after.
5. plain: the same scan with the plain versions swapped in on the card;
   the masks of both runs must agree (Dice >= 0.995, same Otsu bin).

Prints a `{"kernels": [...]}` JSON line and, last, the device line
{"ok": true, "device": {...}}. Any failed check exits non-zero before it.
"""

import contextlib
import faulthandler
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from dram_tpu_torch import weights
from dram_tpu_torch.data.synth import synth_scan
from dram_tpu_torch.infer.fast import FastScanPipeline, prep_scan_chunks
from dram_tpu_torch.kernels import (_build, conv_stack, pool, upsample,
                                    window_attention)
from dram_tpu_torch.models import DC3DATGeneric

ROOT = os.path.dirname(os.path.abspath(__file__))
LIMITS = {"card": 30, "build": 180, "kernel": 60, "weights": 60,
          "pipeline": 120, "plain": 120}
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 tensor-core
# and f32 CUDA-core flop/s
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
SCAN_SHAPE, SPACING, SEED = (160, 192, 192), (1.25, 0.8, 0.8), 0
SEVERITIES = [3, 4, 2, 5, 3]
WINDOW = (-1000, -700)


@contextlib.contextmanager
def phase(name, limit):
    faulthandler.dump_traceback_later(limit, exit=True)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
    print(f"# phase {name} {time.perf_counter() - t0:.2f}", flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, reps=7):
    """Median CUDA-event time of fn() after one warm-up call."""
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
    return float(np.median(times))


def bound(nbytes, flops, peak_flops):
    t_bytes, t_ops = nbytes / HBM_BPS, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def check_kernel(name, kernel, plain, args, tol, library=None, work=None):
    """Hold kernel(*args) against plain(*args); time kernel, plain and the
    library call. `tol(plain_out)` is the allowed max |kernel - plain|."""
    y = kernel(*args)
    torch.cuda.synchronize()
    yp = plain(*args)
    torch.cuda.synchronize()
    err = (y.float() - yp.float()).abs().max().item()
    allowed = tol(yp.float())
    print(f"# {name}: max_abs_err {err:.3g} (allowed {allowed:.3g}), "
          f"max_rel_err {err / max(yp.float().abs().max().item(), 1e-30):.3g}",
          flush=True)
    if not err <= allowed:
        fail(f"{name} disagrees with its plain version")
    ms = cuda_ms(lambda: kernel(*args))
    plain_ms = cuda_ms(lambda: plain(*args))
    library_ms = cuda_ms(library) if library is not None else None
    bound_ms, bound_by = bound(*work(y))
    print(f"# {name}: ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
          f"{library_ms if library_ms is None else round(library_ms, 4)} "
          f"bound_ms {bound_ms:.4f} ({bound_by})", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def bf16_tol(rel):
    """Within `rel` of the largest plain value: both sides sum in f32 in
    another order and round once to bf16 (2^-8 relative)."""
    return lambda yp: rel * yp.abs().max().item()


def kernel_phases(gen):
    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(dtype)

    res = {}
    # conv: the largest conv of the path, us_2 conv_0 at 80^3,
    # [upsample 128 | skip 64] -> 64 channels, batch 5
    x1, x2 = rnd(5, 80, 80, 80, 128), rnd(5, 80, 80, 80, 64)
    w = rnd(64, 192, 3, 3, 3, dtype=torch.float32, scale=0.03)
    s = torch.rand(64, generator=gen, device="cuda") + 0.5
    t = rnd(64, dtype=torch.float32, scale=0.1)
    xcat = torch.cat([x1, x2], -1).permute(0, 4, 1, 2, 3)  # channels_last_3d
    wl = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
    with phase("kernel conv3x3x3", LIMITS["kernel"]):
        res["conv3x3x3"] = check_kernel(
            "conv3x3x3",
            lambda a, b: conv_stack.conv3x3x3(a, w, s, t, x2=b),
            lambda a, b: conv_stack.conv3x3x3_plain(a, w, s, t, x2=b),
            (x1, x2), bf16_tol(2 ** -7),
            library=lambda: F.conv3d(xcat, wl, padding=1),
            work=lambda y: (nbytes(x1, x2, y) + w.numel() * 2,
                            2.0 * y.shape[0] * y.shape[1] * y.shape[2]
                            * y.shape[3] * 27 * 192 * 64, BF16_FLOPS))
    del x1, x2, xcat

    x = rnd(5, 80, 80, 80, 64)
    xl = x.permute(0, 4, 1, 2, 3)
    with phase("kernel maxpool2", LIMITS["kernel"]):
        res["maxpool2"] = check_kernel(
            "maxpool2", pool.maxpool2, pool.maxpool2_plain, (x,),
            lambda yp: 0.0,
            library=lambda: F.max_pool3d(xl, 2, 2),
            work=lambda y: (nbytes(x, y), 7.0 * y.numel(), F32_FLOPS))
    del x, xl

    x = rnd(5, 40, 40, 40, 128)
    xl = x.permute(0, 4, 1, 2, 3)
    with phase("kernel upsample2x", LIMITS["kernel"]):
        res["upsample2x"] = check_kernel(
            "upsample2x", upsample.upsample2x, upsample.upsample2x_plain,
            (x,), bf16_tol(2 ** -7),
            library=lambda: F.interpolate(xl, scale_factor=2,
                                          mode="trilinear",
                                          align_corners=True),
            work=lambda y: (nbytes(x, y), 14.0 * y.numel(), F32_FLOPS))
    del x, xl

    th, ph, g = (rnd(5, 64, 64, 64, 8, dtype=torch.float32)
                 for _ in range(3))
    with phase("kernel stencil_attention", LIMITS["kernel"]):
        # f32 on both sides: summation order and exp rounding only
        res["stencil_attention"] = check_kernel(
            "stencil_attention", window_attention.stencil_attention,
            window_attention.stencil_attention_plain, (th, ph, g),
            lambda yp: 1e-4 * yp.abs().max().item(),
            work=lambda y: (nbytes(th, ph, g, y),
                            18 * 34.0 * th.shape[0] * 64 ** 3, F32_FLOPS))
    return res


WRAPPERS = {"conv3x3x3": (conv_stack, "conv3x3x3"),
            "maxpool2": (pool, "maxpool2"),
            "upsample2x": (upsample, "upsample2x"),
            "stencil_attention": (window_attention, "stencil_attention")}
META = {
    "conv3x3x3": ("dram_tpu_torch/kernels/csrc/conv3x3x3.cu",
                  "dram_tpu/core/pallas/fused_stack.py:305"),
    "maxpool2": ("dram_tpu_torch/kernels/csrc/maxpool2.cu",
                 "dram_tpu/core/pallas/pool.py:236"),
    "upsample2x": ("dram_tpu_torch/kernels/csrc/upsample2x.cu",
                   "dram_tpu/core/pallas/upsample.py:202"),
    "stencil_attention": ("dram_tpu_torch/kernels/csrc/stencil_attention.cu",
                          "dram_tpu/core/pallas/window_attention.py:262"),
}


@contextlib.contextmanager
def plain_versions():
    """Swap every kernel wrapper for its plain version (this script's
    reference run on the card; not a knob of the package)."""
    saved = {k: getattr(mod, attr) for k, (mod, attr) in WRAPPERS.items()}
    for mod, attr in WRAPPERS.values():
        setattr(mod, attr, getattr(mod, attr + "_plain"))
    try:
        yield
    finally:
        for k, (mod, attr) in WRAPPERS.items():
            setattr(mod, attr, saved[k])


def dice(a, b):
    a, b = a > 0, b > 0
    den = int(a.sum()) + int(b.sum())
    return 1.0 if den == 0 else 2.0 * int(np.logical_and(a, b).sum()) / den


def run_scan(pipe, prepc, want_heatmap, label):
    out = pipe.process_chunks(prepc, want_heatmap=want_heatmap)
    ms = out["stage_ms"]
    print(f"# scan {label}: pre {ms['pre']:.1f} ms model {ms['model']:.1f} "
          f"ms post {ms['post']:.1f} ms; threshold {out['threshold']:.6f} "
          f"(bin {round(out['threshold'] * 255)}), pred voxels "
          f"{int(out['pred'].sum())}, post voxels {int(out['post'].sum())}",
          flush=True)
    if out["pred"].shape != SCAN_SHAPE or out["post"].shape != SCAN_SHAPE:
        fail(f"{label}: mask shape {out['pred'].shape}")
    if not (np.isfinite(out["ratios"]).all()
            and 0.0 <= out["threshold"] <= 1.0):
        fail(f"{label}: non-finite ratios or threshold")
    return out


def main():
    with phase("card", LIMITS["card"]):
        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is false: this script needs an "
                 "NVIDIA GPU")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        print(smi.stdout.strip().splitlines()[0], flush=True)
        print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]}", flush=True)
        # reference math in full f32: no TF32 in cuDNN convs or matmuls
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    with phase("build", LIMITS["build"]):
        cold = not os.path.exists(_build.library_path())
        _build.load()
        print(f"# build: {os.path.basename(_build.library_path())} "
              f"({'built now' if cold else 'found built'})", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    res = kernel_phases(gen)
    torch.cuda.empty_cache()

    with phase("weights", LIMITS["weights"]):
        params, batch_stats = weights.load_bench_weights(
            os.path.join(ROOT, "assets", "bench_weights.ckpt.xz"))
        model = weights.load_into(DC3DATGeneric(dtype=torch.bfloat16),
                                  params, batch_stats)
        pipe = FastScanPipeline(model, device="cuda")
        scan, lobe, _, vessel, _ = synth_scan(
            np.random.default_rng(SEED), SCAN_SHAPE,
            lesion_severity=SEVERITIES)
        t0 = time.perf_counter()
        prepc = prep_scan_chunks(scan, lobe, SPACING, vessel_u8=vessel,
                                 windowing_span=WINDOW)
        prep_ms = (time.perf_counter() - t0) * 1e3
        print(f"# host prep {prep_ms:.1f} ms: scan {SCAN_SHAPE} at "
              f"{SPACING} mm -> iso crop {prepc['iso_shape']}, bucket "
              f"{prepc['bucket']}, chunks {prepc['x80_bits'].shape}",
              flush=True)

    with phase("pipeline", LIMITS["pipeline"]):
        for mod, attr in WRAPPERS.values():
            getattr(mod, attr).launches = 0
        a = run_scan(pipe, prepc, False, "kernels, cold")
        b = run_scan(pipe, prepc, True, "kernels, heatmap")
        launches = {k: getattr(mod, attr).launches
                    for k, (mod, attr) in WRAPPERS.items()}
        print(f"# launches over the two scans: {launches}", flush=True)
        missing = [k for k, n in launches.items() if n == 0]
        if missing:
            fail(f"kernels never launched on the main path: {missing}")
        for k in ("pred", "post"):
            if not np.array_equal(a[k], b[k]):
                fail(f"{k} differs between the host and device post rule")
        warm = run_scan(pipe, prepc, False, "kernels, warm")

    with phase("plain", LIMITS["plain"]):
        with plain_versions():
            p = run_scan(pipe, prepc, False, "plain versions")
        d_pred, d_post = dice(warm["pred"], p["pred"]), dice(warm["post"],
                                                            p["post"])
        same_bin = round(warm["threshold"] * 255) == round(p["threshold"]
                                                           * 255)
        print(f"# kernels vs plain on the card: dice pred {d_pred:.6f} post "
              f"{d_post:.6f}, otsu {warm['threshold']:.6f} vs "
              f"{p['threshold']:.6f}, ratios max diff "
              f"{np.abs(warm['ratios'] - p['ratios']).max():.3g}",
              flush=True)
        if not warm["pred"].any():
            fail("empty pred mask")
        if d_pred < 0.995 or d_post < 0.995 or not same_bin:
            fail("kernel run and plain run disagree")

    kernels = [{"name": k, "route": "cuda", "source": META[k][0],
                "replaces": META[k][1], "launches": launches[k], **res[k]}
               for k in WRAPPERS]
    print("# kernels " + json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

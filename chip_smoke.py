#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dram_tpu_torch) once on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each under a faulthandler watchdog that ends a hung run with a
traceback and a non-zero exit:

1. card: the card's name and power limit (nvidia-smi); fails without CUDA.
2. build: nvcc builds the CUDA kernels from dram_tpu_torch/kernels/csrc.
3. one phase per kernel (and per training mode of the conv kernel), at
   its path's largest shape: the kernel against its plain PyTorch version
   on the same inputs (error against the stated tolerance), then
   CUDA-event times (median of 7 after warm-up) of the kernel, the plain
   version and, where one PyTorch call computes the same function, that
   call (timed here only; the port never calls it). The stencil
   attention's two backward passes also hold StencilAttentionFunction's
   gradients against torch autograd through the plain forward.
4. pipeline: the trained flagship DC3DATGeneric (assets/bench_weights.ckpt.xz)
   at full width on a synthetic 160x192x192 scan at anisotropic spacing:
   host prep, then process_chunks with the kernels for want_heatmap False
   and True, with every launch count set to 0 just before and read just
   after.
5. plain: the same scan with the plain versions swapped in on the card;
   the masks of both runs must agree (Dice >= 0.995, same Otsu bin).
6. train: st_dram_ref's DC3D at its published widths in bf16, started
   from the flagship's trained backbone, takes 3 training steps
   (train_steps) on one synthetic batch of 10 x 80^3 lobe chunks with the
   kernels, launch counts set to 0 just before and read just after; per
   step the loss terms, the forward / backward / optimizer times (CUDA
   events) and the peak device memory.
7. train plain: the same 3 steps from the same start with the plain
   versions swapped in; step-1 loss terms, every parameter gradient
   (cosine and relative L2) and the BatchNorm statistics must agree with
   the kernel run.
8. eval conv under grad: the CUDA eval conv raises when an operand
   requires grad (it has no gradient) and runs under torch.no_grad().
9. train att / train att plain: the same two phases for the flagship
   st_dram_ref_att (DC3DATGeneric with the PCM's stencil attention, the
   -1000..-700 HU window), started from the whole trained flagship tree;
   the kernel run must also give every PCM and tap-head parameter a
   non-zero, finite gradient.
10. the unfused conv stack (st_dram_ref_att with USE_FUSED_STACK = False;
   after the plain phase of 4-5 and the kernel phases of 3): pipeline
   unfused / plain unfused, the scan of 4 with the unfused flagship in
   eval mode, whose masks must agree with the plain run's and the fused
   run's; golden, both kernel scans against dram_tpu's CPU masks of the
   same scan (tools/make_port_golden.py), after the hashes of the prepped
   chunk and lobe bits are held against the golden's; and (after 9)
   train unfused / train unfused plain, the phases of 9 for the unfused
   flagship, which runs the raw conv (Conv3dFunction) and the
   first-maximum max-pool backward.
11. conv sweep (after the kernel phases of 3, before 6): ptxas's report
   (registers, spills) and the dynamic shared memory of each Hopper conv
   kernel, and the check that their SASS holds HGMMA and no HMMA; then
   every conv launch of the flagship training step (14 forward, 13 dx,
   14 dW; conv_shapes, read from a meta-device DC3D) in the mode the step
   runs it in, the network-entry conv's one CT channel zero-padded to 8:
   at batch 2 against its plain version (outputs within 2^-7 of the
   largest, statistics within stats_tol, dW within 1e-3), launched twice
   with bitwise-equal results; at batch 10 its time, TFLOP/s and share of
   the bf16 bound beside cuDNN's time for the same conv.
12. upsample sweep (after 11): every upsample launch, forward and adjoint,
   of the scan (batch 5), the flagship step (batch 10) and the training
   golden's step (batch 2 x 48^3), each against its plain version (2^-7
   of the largest) and launched twice with bitwise-equal results; at
   batch 5 and 10 its time, byte bound and share of it beside the
   library call (F.interpolate / aten.upsample_trilinear3d_backward).
13. attention sweep (after 12): ptxas's report (registers, spills) of the
   plane-ring attention kernels (forward and gradient pass), then every
   stencil-attention launch of the scan (forward, batch 5), the flagship
   step (forward, statistics and gradient passes, batch 10) and the
   training golden's step (batch 2), all at 64^3 on a 1/8 grid: each
   against its plain version (1e-4 of the largest), launched twice with
   bitwise-equal results, timed (per launch, over 10 back to back)
   beside its byte bound with its share of it and its plan's tile and
   dynamic shared memory; at batch 2 also
   StencilAttentionFunction's gradients against autograd through the
   plain forward (1e-4).
14. train golden (last): the flagship's kernel step, fused and unfused, at
   the published widths and bf16 activations on the training golden's
   batch (golden.train_golden_batch, 2 x 48^3, -300 HU), held against
   dram_tpu's float64 step (tools/make_port_train_golden.py): loss terms
   and every gradient's cosine at the train gate's limits; the gradients'
   relative L2 (per group) and the BatchNorm batch statistics at the
   golden's own limits (GOLDEN_REL_L2, GOLDEN_BN_REL_L2), placed between
   sound and broken kernels' readings; launch counts zeroed before each
   step and read after (paths train_golden, train_golden_unfused).

Prints a `{"kernels": [...]}` JSON line and, last, the device line
{"ok": true, "device": {...}}. Any failed check exits non-zero before it.
"""

import contextlib
import faulthandler
import re
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from dram_tpu_torch import golden, weights
from dram_tpu_torch.configs import (st_dram_ref, st_dram_ref_att,
                                    with_settings)
from dram_tpu_torch.data.synth import synth_scan, train_batch
from dram_tpu_torch.infer.fast import FastScanPipeline, prep_scan_chunks
from dram_tpu_torch.losses.refine import pseudo_labels
from dram_tpu_torch.kernels import (_build, conv3d, conv_stack, pool,
                                    upsample, window_attention)
from dram_tpu_torch.models import DC3D, DC3DATGeneric
from dram_tpu_torch.train import train_steps
from dram_tpu_torch.train.trainer import build_model

ROOT = os.path.dirname(os.path.abspath(__file__))
LIMITS = {"card": 30, "build": 180, "kernel": 60, "weights": 60,
          "pipeline": 120, "plain": 120, "train": 300, "train_plain": 300,
          "eval_conv_grad": 30, "train_att": 300, "train_att_plain": 300,
          "pipeline_unfused": 120, "plain_unfused": 120, "golden": 60,
          "train_unfused": 300, "train_unfused_plain": 300,
          "conv_sweep": 240, "upsample_sweep": 120, "attention_sweep": 120,
          "train_golden": 240}
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 tensor-core
# and f32 CUDA-core flop/s
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
SCAN_SHAPE, SPACING, SEED = (160, 192, 192), (1.25, 0.8, 0.8), 0
SEVERITIES = [3, 4, 2, 5, 3]
WINDOW = (-1000, -700)
# dram_tpu's masks of that scan (tools/make_port_golden.py)
GOLDEN = "dram_tpu_torch/golden/flagship_scan.npz"
TRAIN_STEPS = 3
# kernel run vs plain run of the training step on the card: step-1 loss
# terms (relative), every parameter gradient's cosine and relative L2, and
# the relative L2 of the BatchNorm batch statistics that step 1 folds into
# the running ones. The sound kernels read 7.5e-3 and 4.4e-5 on the last
# two; PERF.md gives the readings of deliberately broken kernels.
LOSS_RTOL, GRAD_COS_MIN, GRAD_REL_L2, BN_REL_L2 = 1e-2, 0.99, 3e-2, 1e-3
# the kernel step (bf16 activations) vs dram_tpu's float64 step (the
# train golden): loss terms and cosine as above; the relative L2 of the
# gradients' seeded projections per group, and of the BatchNorm batch
# statistics, placed between the sound kernels' readings (backbone
# 3.16e-2, PCM and tap heads 0.113, statistics 3.08e-3: bf16 rounding,
# over the limits above) and those of broken ones (0.152, 0.762, 9.97e-2
# at the nearest; PERF.md, the train golden table)
GOLDEN_REL_L2 = {"backbone": 0.07, "PCM and tap heads": 0.3}
GOLDEN_BN_REL_L2 = 1e-2


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


def _outputs(y):
    return y if isinstance(y, tuple) else (y,)


def check_kernel(name, kernel, plain, args, tol, library=None, work=None):
    """Hold kernel(*args) against plain(*args); time kernel, plain and the
    library call. Each may return a tensor or a tuple of them; `tol` (or
    one per output) maps a plain output to the allowed max
    |kernel - plain|. max_abs_err is the largest over the outputs."""
    y = _outputs(kernel(*args))
    torch.cuda.synchronize()
    yp = _outputs(plain(*args))
    torch.cuda.synchronize()
    tols = tol if isinstance(tol, tuple) else (tol,) * len(y)
    errs = []
    for k, (a, b, t) in enumerate(zip(y, yp, tols)):
        err = (a.float() - b.float()).abs().max().item()
        allowed = t(b.float())
        tag = name if len(y) == 1 else f"{name} output {k}"
        print(f"# {tag}: max_abs_err {err:.3g} (allowed {allowed:.3g}), "
              f"max_rel_err "
              f"{err / max(b.float().abs().max().item(), 1e-30):.3g}",
              flush=True)
        if not err <= allowed:
            fail(f"{tag} disagrees with its plain version")
        errs.append(err)
    ms = cuda_ms(lambda: kernel(*args))
    plain_ms = cuda_ms(lambda: plain(*args))
    library_ms = cuda_ms(library) if library is not None else None
    bound_ms, bound_by = bound(*work(*y))
    print(f"# {name}: ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
          f"{library_ms if library_ms is None else round(library_ms, 4)} "
          f"bound_ms {bound_ms:.4f} ({bound_by})", flush=True)
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
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


def stats_tol(y_plain_f32):
    """Allowed |kernel - plain| of the (2, Co) [sum, sum of squares]
    statistics: 1e-4 of the channel's sum of |y| and of y^2 (both sides
    add the same f32 values in another order; the kernel in 64-row blocks,
    then per-block rows in two fixed passes)."""
    dims = (0, 1, 2, 3)
    lim = torch.stack([y_plain_f32.abs().sum(dims),
                       (y_plain_f32 * y_plain_f32).sum(dims)])
    return 1e-4 * lim


def check_stats(name, st, st_plain, lim):
    err = (st - st_plain).abs()
    worst = (err / lim).max().item()
    print(f"# {name} statistics: max_abs_err {err.max().item():.3g}, worst "
          f"share of the allowed error {worst:.3g}", flush=True)
    if not worst <= 1.0:
        fail(f"{name} statistics disagree with the plain version")


def train_kernel_phases(gen):
    """The training kernels at the st_dram_ref step's largest shapes
    (batch 10 x 80^3; us_2's conv_0 [upsample 128 | skip 64] -> 64 for the
    convs, ds_0's 64-channel pool, us_2's 128-channel upsample)."""
    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(dtype)

    res = {}
    V = 10 * 80 ** 3
    x1, x2 = rnd(10, 80, 80, 80, 128), rnd(10, 80, 80, 80, 64)
    w = rnd(64, 192, 3, 3, 3, dtype=torch.float32, scale=0.03)
    xcat = torch.cat([x1, x2], -1).permute(0, 4, 1, 2, 3)  # channels_last_3d
    wl = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
    flops = 2.0 * V * 27 * 192 * 64
    with phase("kernel conv3x3x3_train", LIMITS["kernel"]):
        # raw output + statistics (conv_0's mode), then the prologue mode
        # of conv_1 (64 -> 64) held against its plain version too
        y, st = conv_stack.conv3x3x3_train(x1, w, x2=x2, stats=True)
        yp, stp = conv_stack.conv3x3x3_train_plain(x1, w, x2=x2, stats=True)
        check_stats("conv3x3x3_train", st, stp, stats_tol(yp.float()))
        del y, yp
        h = torch.relu(rnd(10, 80, 80, 80, 64))
        w1 = rnd(64, 64, 3, 3, 3, dtype=torch.float32, scale=0.05)
        pro = (torch.rand(64, generator=gen, device="cuda") + 0.5,
               rnd(64, dtype=torch.float32, scale=0.3))
        y, st = conv_stack.conv3x3x3_train(h, w1, prologue=pro, stats=True)
        yp, stp = conv_stack.conv3x3x3_train_plain(h, w1, prologue=pro,
                                                   stats=True)
        err = (y.float() - yp.float()).abs().max().item()
        allowed = 2 ** -7 * yp.float().abs().max().item()
        print(f"# conv3x3x3_train prologue 64 -> 64: max_abs_err {err:.3g} "
              f"(allowed {allowed:.3g})", flush=True)
        if not err <= allowed:
            fail("conv3x3x3_train prologue mode disagrees with its plain "
                 "version")
        check_stats("conv3x3x3_train prologue", st, stp,
                    stats_tol(yp.float()))
        del y, yp, h
        res["conv3x3x3_train"] = check_kernel(
            "conv3x3x3_train",
            lambda a, b: conv_stack.conv3x3x3_train(a, w, x2=b,
                                                    stats=True)[0],
            lambda a, b: conv_stack.conv3x3x3_train_plain(a, w, x2=b,
                                                          stats=True)[0],
            (x1, x2), bf16_tol(2 ** -7),
            library=lambda: F.conv3d(xcat, wl, padding=1),
            work=lambda y: (nbytes(x1, x2, y) + w.numel() * 2, flops,
                            BF16_FLOPS))
        # the prologue and statistics modes together at this shape (the
        # step runs the prologue on one-part conv_1s only): held against
        # the plain version, and timed beside the raw output's time
        pro = (torch.rand(192, generator=gen, device="cuda") + 0.5,
               rnd(192, dtype=torch.float32, scale=0.3))
        y, st = conv_stack.conv3x3x3_train(x1, w, x2=x2, prologue=pro,
                                           stats=True)
        yp, stp = conv_stack.conv3x3x3_train_plain(x1, w, x2=x2,
                                                   prologue=pro, stats=True)
        err = (y.float() - yp.float()).abs().max().item()
        allowed = 2 ** -7 * yp.float().abs().max().item()
        print(f"# conv3x3x3_train prologue [128|64] -> 64: max_abs_err "
              f"{err:.3g} (allowed {allowed:.3g})", flush=True)
        if not err <= allowed:
            fail("conv3x3x3_train prologue mode on two parts disagrees "
                 "with its plain version")
        check_stats("conv3x3x3_train prologue [128|64]", st, stp,
                    stats_tol(yp.float()))
        del y, yp
        ms = cuda_ms(lambda: conv_stack.conv3x3x3_train(
            x1, w, x2=x2, prologue=pro, stats=True))
        print(f"# conv3x3x3_train prologue + statistics [128|64] -> 64: ms "
              f"{ms:.4f} (raw output + statistics "
              f"{res['conv3x3x3_train']['ms']:.4f})", flush=True)

    dy = rnd(10, 80, 80, 80, 64)
    dyl = dy.permute(0, 4, 1, 2, 3)
    with phase("kernel conv3x3x3_dx", LIMITS["kernel"]):
        res["conv3x3x3_dx"] = check_kernel(
            "conv3x3x3_dx",
            lambda g: conv_stack.conv3x3x3_dx(g, w, split=(128, 64)),
            lambda g: conv_stack.conv3x3x3_dx_plain(g, w, split=(128, 64)),
            (dy,), bf16_tol(2 ** -7),
            library=lambda: torch.nn.grad.conv3d_input(
                xcat.shape, wl, dyl, padding=1),
            work=lambda a, b: (nbytes(dy, a, b) + w.numel() * 2, flops,
                               BF16_FLOPS))

    with phase("kernel conv3x3x3_dw", LIMITS["kernel"]):
        # the prologue mode (conv_1's dW) held against its plain version
        h = torch.relu(rnd(10, 80, 80, 80, 64))
        pro = (torch.rand(64, generator=gen, device="cuda") + 0.5,
               rnd(64, dtype=torch.float32, scale=0.3))
        a = conv_stack.conv3x3x3_dw(h, dy, prologue=pro)
        b = conv_stack.conv3x3x3_dw_plain(h, dy, prologue=pro)
        err = (a - b).abs().max().item()
        allowed = 1e-3 * b.abs().max().item()
        print(f"# conv3x3x3_dw prologue 64 -> 64: max_abs_err {err:.3g} "
              f"(allowed {allowed:.3g})", flush=True)
        if not err <= allowed:
            fail("conv3x3x3_dw prologue mode disagrees with its plain "
                 "version")
        del h, a, b
        # f32 sums of the same bf16 products over 5.12 M voxels in another
        # order: 1e-3 of the largest weight gradient
        res["conv3x3x3_dw"] = check_kernel(
            "conv3x3x3_dw",
            lambda a, b, g: conv_stack.conv3x3x3_dw(a, g, x2=b),
            lambda a, b, g: conv_stack.conv3x3x3_dw_plain(a, g, x2=b),
            (x1, x2, dy), lambda yp: 1e-3 * yp.abs().max().item(),
            library=lambda: torch.nn.grad.conv3d_weight(
                xcat, wl.shape, dyl, padding=1),
            work=lambda dw: (nbytes(x1, x2, dy, dw), flops, BF16_FLOPS))
    del x1, x2, xcat, dy, dyl

    # the pool's input is post-ReLU: exact zeros tie inside windows
    x = torch.relu(rnd(10, 80, 80, 80, 64))
    g = rnd(10, 40, 40, 40, 64)
    with phase("kernel maxpool2_bwd", LIMITS["kernel"]):
        # no PyTorch call splits the cotangent over tied maxima
        # (F.max_pool3d's backward routes it to one position): no library
        res["maxpool2_bwd"] = check_kernel(
            "maxpool2_bwd", pool.maxpool2_bwd, pool.maxpool2_bwd_plain,
            (x, g), lambda yp: 0.0,
            work=lambda dx: (nbytes(x, g, dx), 20.0 * x.numel(), F32_FLOPS))
    del x, g

    dy = rnd(10, 80, 80, 80, 128)
    dyl = dy.permute(0, 4, 1, 2, 3)
    with phase("kernel upsample2x_bwd", LIMITS["kernel"]):
        res["upsample2x_bwd"] = check_kernel(
            "upsample2x_bwd", upsample.upsample2x_bwd,
            upsample.upsample2x_bwd_plain, (dy,), bf16_tol(2 ** -7),
            library=lambda: torch.ops.aten.upsample_trilinear3d_backward(
                dyl, [80, 80, 80], [10, 128, 40, 40, 40], True),
            work=lambda dx: (nbytes(dy, dx), 16.0 * dy.numel(), F32_FLOPS))
    del dy, dyl
    res.update(attention_backward_phases(gen))
    return res


def attention_backward_phases(gen):
    """The stencil attention's two backward kernels at the flagship step's
    shape (batch 10 x 64^3, F = G = 8, f32), each against its plain
    version, then StencilAttentionFunction's gradients against torch
    autograd through the plain forward with the same cotangent; and the
    forward's time at this batch.

    The inputs lie on a 1/8 grid, so every dot product of the pass (the
    logits' theta . phi, u's ybar . g) is exact in f32 in any summation
    order: the kernel and the plain version then take the same side of
    the relu kink, where the gradient jumps. With continuous random
    inputs about a dozen of the 47 M logits fall within rounding of 0 and
    the two sides may differ there by a whole step of ds."""
    th, ph, g, yb = (torch.round(torch.randn(
        10, 64, 64, 64, 8, generator=gen, device="cuda") * 8) / 8
        for _ in range(4))
    # valid (voxel, neighbour) pairs: the work of every pass is per pair
    edges = 10 * int(window_attention.valid_masks(
        (64, 64, 64), window_attention.KERNEL_OFFSETS).sum())
    # f32 on both sides: summation order and exp rounding only
    rel = lambda yp: 1e-4 * yp.abs().max().item()  # noqa: E731
    res = {}
    with phase("kernel stencil_attention_scal", LIMITS["kernel"]):
        # the four statistics (r, m, denom, c) are held one by one
        res["stencil_attention_scal"] = check_kernel(
            "stencil_attention_scal",
            lambda *a: window_attention.stencil_attention_scal(*a).unbind(-1),
            lambda *a: window_attention.stencil_attention_scal_plain(
                *a).unbind(-1),
            (th, ph, g, yb), rel,
            work=lambda *sc: (nbytes(th, ph, g, yb, *sc), 38.0 * edges,
                              F32_FLOPS))
    scal = window_attention.stencil_attention_scal_plain(th, ph, g, yb)
    with phase("kernel stencil_attention_bwd", LIMITS["kernel"]):
        res["stencil_attention_bwd"] = check_kernel(
            "stencil_attention_bwd", window_attention.stencil_attention_bwd,
            window_attention.stencil_attention_bwd_plain,
            (th, ph, g, yb, scal), rel,
            work=lambda *d: (nbytes(th, ph, g, yb, scal, *d), 128.0 * edges,
                             F32_FLOPS))
        leaves = [t.clone().requires_grad_() for t in (th, ph, g)]
        got = torch.autograd.grad(window_attention.stencil_attention(*leaves),
                                  leaves, yb)
        want = torch.autograd.grad(
            window_attention.stencil_attention_plain(*leaves), leaves, yb)
        for name, a, b in zip(("dtheta", "dphi", "dg"), got, want):
            err, allowed = (a - b).abs().max().item(), rel(b)
            print(f"# StencilAttentionFunction {name} vs autograd of the "
                  f"plain forward: max_abs_err {err:.3g} (allowed "
                  f"{allowed:.3g})", flush=True)
            if not err <= allowed:
                fail(f"StencilAttentionFunction {name} disagrees with "
                     "autograd of stencil_attention_plain")
        del leaves, got, want
        ms = cuda_ms(lambda: window_attention.stencil_attention(th, ph, g))
        bound_ms, _ = bound(nbytes(th, ph, g, g), 34.0 * edges, F32_FLOPS)
        print(f"# stencil_attention at the training batch 10 x 64^3: ms "
              f"{ms:.4f} bound_ms {bound_ms:.4f} (bytes)", flush=True)
    return res


def unfused_kernel_phases(gen):
    """The unfused stack's kernels at its step's largest shapes, batch
    10 x 80^3: the raw conv (row 10) and its dx and dW (row 11) on us_2's
    conv_0 [upsample 128 | skip 64] -> 64 and on ds_0's conv_1 32 -> 64;
    the first-maximum max-pool backward on ds_0's 64 channels."""
    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(dtype)

    res = {}
    V = 10 * 80 ** 3
    x1, x2 = rnd(10, 80, 80, 80, 128), rnd(10, 80, 80, 80, 64)
    w = rnd(64, 192, 3, 3, 3, dtype=torch.float32, scale=0.03)
    xcat = torch.cat([x1, x2], -1).permute(0, 4, 1, 2, 3)  # channels_last_3d
    wl = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
    xs = rnd(10, 80, 80, 80, 32)
    ws = rnd(64, 32, 3, 3, 3, dtype=torch.float32, scale=0.06)
    flops = 2.0 * V * 27 * 192 * 64
    def check_entry(name, a, b):
        """ds_0's 32 -> 64 shape, held against its plain version only."""
        err = (a.float() - b.float()).abs().max().item()
        allowed = 2 ** -7 * b.float().abs().max().item()
        print(f"# {name} 32 -> 64: max_abs_err {err:.3g} (allowed "
              f"{allowed:.3g})", flush=True)
        if not err <= allowed:
            fail(f"{name} 32 -> 64 disagrees with its plain version")

    with phase("kernel conv3d", LIMITS["kernel"]):
        check_entry("conv3d", conv3d.conv3d(xs, ws),
                    conv3d.conv3d_plain(xs, ws))
        res["conv3d"] = check_kernel(
            "conv3d", lambda a, b: conv3d.conv3d(a, w, x2=b),
            lambda a, b: conv3d.conv3d_plain(a, w, x2=b), (x1, x2),
            bf16_tol(2 ** -7),
            library=lambda: F.conv3d(xcat, wl, padding=1),
            work=lambda y: (nbytes(x1, x2, y) + w.numel() * 2, flops,
                            BF16_FLOPS))

    dy = rnd(10, 80, 80, 80, 64)
    dyl = dy.permute(0, 4, 1, 2, 3)
    with phase("kernel conv3d_bwd", LIMITS["kernel"]):
        # dW after its bf16 rounding, as Conv3dFunction hands it on
        check_entry("conv3d dx", conv3d.conv3d_dx(dy, ws),
                    conv3d.conv3d_dx_plain(dy, ws))
        check_entry("conv3d dW", conv3d.conv3d_dw(xs, dy).to(torch.bfloat16),
                    conv3d.conv3d_dw_plain(xs, dy).to(torch.bfloat16))
        res["conv3d_dx"] = check_kernel(
            "conv3d_dx", lambda g: conv3d.conv3d_dx(g, w, split=(128, 64)),
            lambda g: conv3d.conv3d_dx_plain(g, w, split=(128, 64)), (dy,),
            bf16_tol(2 ** -7),
            library=lambda: torch.nn.grad.conv3d_input(
                xcat.shape, wl, dyl, padding=1),
            work=lambda a, b: (nbytes(dy, a, b) + w.numel() * 2, flops,
                               BF16_FLOPS))
        # f32 sums of the same bf16 products in another order, then both
        # rounded to bf16: within one bf16 ulp of the largest
        res["conv3d_dw"] = check_kernel(
            "conv3d_dw",
            lambda a, b, g: conv3d.conv3d_dw(a, g, x2=b).to(torch.bfloat16),
            lambda a, b, g: conv3d.conv3d_dw_plain(a, g, x2=b).to(
                torch.bfloat16),
            (x1, x2, dy), bf16_tol(2 ** -7),
            library=lambda: torch.nn.grad.conv3d_weight(
                xcat, wl.shape, dyl, padding=1),
            work=lambda dw: (nbytes(x1, x2, dy) + dw.numel() * 4, flops,
                             BF16_FLOPS))
    del x1, x2, xcat, dy, dyl, xs

    # post-ReLU zeros and duplicated rows: ties of 2, 4 and 8 in windows
    x = torch.relu(rnd(10, 80, 80, 80, 64))
    x[:, :, ::2] = x[:, :, 1::2]
    g = rnd(10, 40, 40, 40, 64)
    with phase("kernel maxpool2_bwd first", LIMITS["kernel"]):
        res["maxpool2_bwd_first"] = check_kernel(
            "maxpool2_bwd_first", pool.maxpool2_bwd_first,
            pool.maxpool2_bwd_first_plain, (x, g), lambda yp: 0.0,
            library=maxpool_first_library(x, g),
            work=lambda dx: (nbytes(x, g, dx), 16.0 * x.numel(), F32_FLOPS))
    del x, g
    return res


def maxpool_first_library(x, g):
    """PyTorch's max_pool3d_with_indices_backward with the indices of
    F.max_pool3d(..., return_indices=True), computed once outside the
    timed call (autograd keeps them from the forward): the library call
    of the first-maximum pool backward, if its output equals the plain
    version's on these tied inputs (else None, with the reason)."""
    xl, gl = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
    _, idx = F.max_pool3d(xl, 2, 2, return_indices=True)

    def lib():
        return torch.ops.aten.max_pool3d_with_indices_backward(
            gl, xl, [2, 2, 2], [2, 2, 2], [0, 0, 0], [1, 1, 1], False, idx)
    got = lib().permute(0, 2, 3, 4, 1)
    want = pool.maxpool2_bwd_first_plain(x, g)
    torch.cuda.synchronize()
    if torch.equal(got, want):
        print("# maxpool2_bwd_first library: max_pool3d_with_indices_"
              "backward with F.max_pool3d's indices equals the plain "
              "version", flush=True)
        return lib
    print(f"# maxpool2_bwd_first library: max_pool3d_with_indices_backward "
          f"differs from the plain version at "
          f"{int((got != want).sum())} elements; library_ms null",
          flush=True)
    return None


def eval_conv_grad_phase(gen):
    """The CUDA eval conv has no gradient: with an operand that requires
    grad it must raise, and under torch.no_grad() it must run."""
    x = torch.randn(1, 8, 8, 8, 64, generator=gen, device="cuda").to(
        torch.bfloat16)
    w = (torch.randn(64, 64, 3, 3, 3, generator=gen, device="cuda")
         * 0.05).requires_grad_()
    s, t = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    try:
        conv_stack.conv3x3x3(x, w, s, t)
    except RuntimeError as e:
        print(f"# eval conv with grad enabled and w.requires_grad raises: "
              f"{e}", flush=True)
    else:
        fail("the CUDA eval conv returned a result without autograd "
             "history instead of raising")
    with torch.no_grad():
        y = conv_stack.conv3x3x3(x, w, s, t)
    if y.shape != (1, 8, 8, 8, 64) or not torch.isfinite(y.float()).all():
        fail("the CUDA eval conv under torch.no_grad() did not run")


# the Hopper conv kernels (csrc/conv3x3x3.cu, csrc/conv3x3x3_dw.cu)
WGMMA_KERNELS = ("conv3x3x3_wgmma_kernel", "conv3x3x3_dw_wgmma_kernel")


def wgmma_build_report():
    """ptxas's lines (-Xptxas -v) of the Hopper conv kernels, their dynamic
    shared memory, and their SASS: each must hold HGMMA and no HMMA (a
    build that fell back to the legacy tensor-core path fails)."""
    entry = None
    for line in open(_build.ptxas_log_path()).read().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1) if any(k in m.group(1)
                                      for k in WGMMA_KERNELS) else None
            continue
        if entry and ("registers" in line or "spill" in line):
            name = re.search(r"(conv3x3x3\w*_wgmma_kernel)(ILi(\d+)ELi(\d+))?",
                             entry)
            tag = name.group(1) + (f"<{name.group(3)}, {name.group(4)}>"
                                   if name.group(2) else "")
            print(f"# ptxas {tag}: {line.split(':', 1)[-1].strip()}",
                  flush=True)
    lib = _build.load()
    for bn, slabs in ((32, 2), (64, 2), (128, 2), (256, 1)):
        print(f"# conv3x3x3_wgmma_kernel<{bn}, {slabs}>: "
              f"{lib.conv3x3x3_wgmma_smem(bn, slabs)} bytes of dynamic "
              "shared memory", flush=True)
    print(f"# conv3x3x3_dw_wgmma_kernel: {lib.conv3x3x3_dw_wgmma_smem()} "
          "bytes of dynamic shared memory", flush=True)
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _build.library_path()],
                          capture_output=True, text=True, timeout=60).stdout
    found = 0
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0].strip()
        if not any(k in name for k in WGMMA_KERNELS):
            continue
        found += 1
        hg = len(re.findall(r"\bHGMMA\b", fn))
        hm = len(re.findall(r"\bHMMA\b", fn))
        print(f"# sass {name[:110]}: {hg} HGMMA, {hm} HMMA", flush=True)
        if hg == 0 or hm:
            fail(f"{name}: the Hopper conv kernel's SASS has {hg} HGMMA and "
                 f"{hm} HMMA instructions")
    if found != 5:
        fail(f"expected 5 Hopper conv kernels in the SASS, found {found}")


def conv_shapes(size=80):
    """The 3x3x3 convs of the flagship DC3D on size^3 chunks, read from a
    meta-device model in forward order: (name, edge, (C1, C2), Co), where
    edge is the level's volume edge and C2 the skip part of a decoder
    conv_0's [upsample, skip] input (0 for one part)."""
    with torch.device("meta"):
        m = DC3D(stacking=3)
    n, out = m.n_layers, []

    def block(name, mod, edge, skip=0):
        w0, w1 = mod.convs.conv_0.weight, mod.convs.conv_1.weight
        out.append((f"{name}.conv_0", edge, (w0.shape[1] - skip, skip),
                    w0.shape[0]))
        out.append((f"{name}.conv_1", edge, (w1.shape[1], 0), w1.shape[0]))
    for i, mod in enumerate(m.ds_modules):
        block(f"ds_{i}", mod, size >> i)
    block("bg", m.bg, size >> n)
    for i, mod in enumerate(m.us_modules):
        skip = m.ds_modules[n - 1 - i].convs.conv_1.weight.shape[0]
        block(f"us_{i}", mod, size >> (n - 1 - i), skip)
    return out


def flagship_conv_launches():
    """(kind, name, edge, (C1, C2), Co, mode) of the flagship training
    step's conv launches: per conv the forward (conv_0: raw output and
    statistics of a one- or two-part input; conv_1: prologue and
    statistics), the dx (none for the CT input; conv_0's split into its
    two parts) and the dW (conv_1's with the prologue)."""
    out = []
    for name, e, parts, co in conv_shapes():
        first = name.endswith("conv_0")
        out.append(("fwd", name, e, parts, co,
                    "raw+stats" if first else "prologue+stats"))
        if name != "ds_0.conv_0":
            out.append(("dx", name, e, (co, 0), parts,
                        "split" if parts[1] else "one part"))
        out.append(("dw", name, e, parts, co,
                    "two parts" if parts[1] else
                    "one part" if first else "prologue"))
    return out


def conv_sweep_phase(gen):
    """Every conv launch of the flagship training step: checked at batch
    2, timed at batch 10 beside cuDNN. Returns the per-launch records."""
    wgmma_build_report()
    torch.cuda.synchronize()
    records = []
    for kind, name, e, (c1, c2), co, mode in flagship_conv_launches():
        recs = {}
        for B in (2, 10):
            def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
                return (torch.randn(*shape, generator=gen, device="cuda")
                        * scale).to(dtype)
            ci = c1 + c2
            x1 = rnd(B, e, e, e, c1)
            x2 = rnd(B, e, e, e, c2) if c2 else None
            pro = (torch.rand(ci, generator=gen, device="cuda") + 0.5,
                   rnd(ci, scale=0.3, dtype=torch.float32)) \
                if mode == "prologue+stats" or mode == "prologue" else None
            if kind == "dx":
                nout = sum(co)
                w = rnd(c1, nout, 3, 3, 3, scale=(27 * c1) ** -0.5,
                        dtype=torch.float32)
                split = co if co[1] else None
                new = lambda: conv_stack.conv3x3x3_dx(x1, w, split)  # noqa
                plain = lambda: conv_stack.conv3x3x3_dx_plain(x1, w, split)  # noqa
                flops = 2.0 * 27 * c1 * nout * B * e ** 3
                moved = nbytes(x1) * (1 + nout / c1) + w.numel() * 2
            elif kind == "fwd":
                w = rnd(co, ci, 3, 3, 3, scale=(27 * ci) ** -0.5,
                        dtype=torch.float32)
                new = lambda: conv_stack.conv3x3x3_train(  # noqa
                    x1, w, x2=x2, prologue=pro, stats=True)
                plain = lambda: conv_stack.conv3x3x3_train_plain(  # noqa
                    x1, w, x2=x2, prologue=pro, stats=True)
                flops = 2.0 * 27 * ci * co * B * e ** 3
                moved = (nbytes(x1) / c1) * (ci + co) + w.numel() * 2
            else:
                dy = rnd(B, e, e, e, co)
                new = lambda: conv_stack.conv3x3x3_dw(  # noqa
                    x1, dy, x2=x2, prologue=pro)
                plain = lambda: conv_stack.conv3x3x3_dw_plain(  # noqa
                    x1, dy, x2=x2, prologue=pro)
                flops = 2.0 * 27 * ci * co * B * e ** 3
                moved = (nbytes(x1) / c1) * (ci + co) + 27 * ci * co * 4
            tag = (f"{kind} {name} {B}x{e}^3 "
                   f"{c1 if not c2 else f'[{c1}|{c2}]'} -> "
                   f"{co if kind != 'dx' else (co[0] if not co[1] else f'[{co[0]}|{co[1]}]')}"
                   f" {mode}{' (padded to 8)' if ci % 8 else ''}")
            if B == 2:
                a, b = _outputs(new()), _outputs(plain())
                a2 = _outputs(new())
                torch.cuda.synchronize()
                errs = []
                for k, (u, v) in enumerate(zip(a, b)):
                    if v is None:
                        continue
                    if kind == "fwd" and k == 1:
                        lim = stats_tol(b[0].float())
                        share = ((u - v).abs() / lim).max().item()
                        errs.append(f"stats {share:.3g} of allowed")
                        if not share <= 1.0:
                            fail(f"sweep {tag}: statistics disagree")
                        continue
                    rel = 1e-3 if kind == "dw" else 2 ** -7
                    err = (u.float() - v.float()).abs().max().item()
                    allowed = rel * v.float().abs().max().item()
                    errs.append(f"err {err:.3g} (allowed {allowed:.3g})")
                    if not err <= allowed:
                        fail(f"sweep {tag}: output {k} disagrees with its "
                             "plain version")
                same = all(torch.equal(u, v) for u, v in zip(a, a2)
                           if u is not None)
                if not same:
                    fail(f"sweep {tag}: two launches differ bitwise")
                print(f"# sweep {tag}: {', '.join(errs)}; repeat bitwise "
                      "equal", flush=True)
                del a, b, a2
                continue
            ms = cuda_ms(new, reps=5)
            xl = (x1 if x2 is None else torch.cat([x1, x2], -1)).permute(
                0, 4, 1, 2, 3)
            if kind == "fwd":
                wl = w.to(torch.bfloat16).contiguous(
                    memory_format=torch.channels_last_3d)
                lib = lambda: F.conv3d(xl, wl, padding=1)  # noqa
            elif kind == "dx":
                wl = w.to(torch.bfloat16).contiguous(
                    memory_format=torch.channels_last_3d)
                shape = (B, sum(co), e, e, e)
                lib = lambda: torch.nn.grad.conv3d_input(  # noqa
                    shape, wl, xl, padding=1)
            else:
                dyl = dy.permute(0, 4, 1, 2, 3)
                lib = lambda: torch.nn.grad.conv3d_weight(  # noqa
                    xl, (co, ci, 3, 3, 3), dyl, padding=1)
            lib_ms = cuda_ms(lib, reps=5)
            bound_ms, _ = bound(moved, flops, BF16_FLOPS)
            recs = {"kind": kind, "name": name, "edge": e, "parts": [c1, c2],
                    "out": co, "mode": mode,
                    "ms": ms, "tflops": flops / ms / 1e9,
                    "bound_ms": bound_ms, "share_of_bound": bound_ms / ms,
                    "cudnn_ms": lib_ms}
            print(f"# sweep {tag}: ms {ms:.4f} ({flops / ms / 1e9:.1f} "
                  f"TFLOP/s, {100 * bound_ms / ms:.1f}% of the bf16 bound "
                  f"{bound_ms:.4f} ms); cuDNN {lib_ms:.4f} ms"
                  f"{' (no prologue)' if pro is not None else ''}",
                  flush=True)
            del xl
        records.append(recs)
        torch.cuda.empty_cache()
    tot = {k: sum(r["ms"] for r in records if r["kind"] == k)
           for k in ("fwd", "dx", "dw")}
    lib = {k: sum(r["cudnn_ms"] for r in records if r["kind"] == k)
           for k in ("fwd", "dx", "dw")}
    print(f"# sweep totals at batch 10 (ms, this kernel / cuDNN): "
          + ", ".join(f"{k} {tot[k]:.2f} / {lib[k]:.2f}" for k in tot),
          flush=True)
    print("# sweep " + json.dumps(records), flush=True)
    return records


def upsample_launches():
    """(kind, level, B, input edge, C) of every upsample launch: the
    scan's forwards (batch 5) and the flagship step's forwards and
    adjoints (batch 10) at its three decoder levels (read from
    conv_shapes: a level's conv_0 takes [upsample | skip]), then the
    training golden's step (batch 2 x 48^3), whose edges are not powers
    of two."""
    levels = [(name.split(".")[0], e // 2, c1)
              for name, e, (c1, c2), co in conv_shapes() if c2]
    small = [(name.split(".")[0], e // 2, c1)
             for name, e, (c1, c2), co in conv_shapes(48) if c2]
    return ([("fwd", lv, 5, e, c) for lv, e, c in levels]
            + [(k, lv, 10, e, c) for k in ("fwd", "bwd")
               for lv, e, c in levels]
            + [(k, lv, 2, e, c) for k in ("fwd", "bwd")
               for lv, e, c in small])


def upsample_sweep_phase(gen):
    """Every upsample launch (upsample_launches): the kernel against its
    plain version (within 2^-7 of the largest value), launched twice with
    bitwise-equal results; at the scan's and the step's batches its time,
    byte bound and share of it, beside the library call's time
    (F.interpolate trilinear align_corners / its aten backward). Returns
    the per-launch records."""
    records = []
    for kind, lv, B, e, C in upsample_launches():
        fwd = kind == "fwd"
        shape = (B, e, e, e, C) if fwd else (B, 2 * e, 2 * e, 2 * e, C)
        x = torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        new, plain = (upsample.upsample2x, upsample.upsample2x_plain) \
            if fwd else (upsample.upsample2x_bwd,
                         upsample.upsample2x_bwd_plain)
        y, yp, y2 = new(x), plain(x), new(x)
        torch.cuda.synchronize()
        err = (y.float() - yp.float()).abs().max().item()
        allowed = 2 ** -7 * yp.float().abs().max().item()
        same = torch.equal(y, y2)
        tag = f"{kind} {lv} {B}x{shape[1]}^3x{C}"
        rec = {"kind": kind, "level": lv, "batch": B, "shape": list(shape),
               "max_abs_err": err, "allowed": allowed}
        line = (f"# upsample sweep {tag}: max_abs_err {err:.3g} (allowed "
                f"{allowed:.3g}), repeat "
                f"{'bitwise equal' if same else 'DIFFERS'}")
        if not err <= allowed:
            fail(f"upsample sweep {tag}: disagrees with its plain version")
        if not same:
            fail(f"upsample sweep {tag}: two launches differ bitwise")
        if B != 2:
            xl = x.permute(0, 4, 1, 2, 3)
            def lib():
                if fwd:
                    return F.interpolate(xl, scale_factor=2,
                                         mode="trilinear", align_corners=True)
                return torch.ops.aten.upsample_trilinear3d_backward(
                    xl, [2 * e] * 3, [B, C, e, e, e], True)
            ms = cuda_ms(lambda: new(x))
            lib_ms = cuda_ms(lib)
            bound_ms, _ = bound(nbytes(x, y), 0.0, F32_FLOPS)
            rec.update(ms=ms, bound_ms=bound_ms, share=bound_ms / ms,
                       library_ms=lib_ms)
            line += (f"; ms {ms:.4f}, bound {bound_ms:.4f} ms (bytes), "
                     f"{100 * bound_ms / ms:.1f}% of it; library "
                     f"{lib_ms:.4f} ms")
            del xl
        print(line, flush=True)
        records.append(rec)
        del x, y, yp, y2
        torch.cuda.empty_cache()
    for kind, B in (("fwd", 5), ("fwd", 10), ("bwd", 10)):
        sel = [r for r in records if r["kind"] == kind and r["batch"] == B]
        print(f"# upsample sweep totals {kind} batch {B} (ms, kernel / "
              f"bound / library): {sum(r['ms'] for r in sel):.4f} / "
              f"{sum(r['bound_ms'] for r in sel):.4f} / "
              f"{sum(r['library_ms'] for r in sel):.4f}", flush=True)
    print("# upsample sweep " + json.dumps(records), flush=True)
    return records


# the plane-ring attention kernels (csrc/stencil_attention.cu)
ATTENTION_RING_KERNELS = ("stencil_attention_kernel",
                          "stencil_attention_bwd_kernel")
# the attention sweep times this many launches back to back and reports
# the time per launch: timed alone, a call's host time in the Python
# wrapper, which the device waits for, is about as long as a batch-2
# launch (tools/attention_variants.py, wrapper against direct launches)
ATT_REPEAT = 10


def attention_launches():
    """(pass, batch) of every stencil-attention launch, all on the PCM's
    64^3 grid: the scan's forward (batch 5), the flagship step's forward,
    statistics and gradient passes (batch 10), and the training golden's
    step (batch 2)."""
    return [("fwd", 5), ("fwd", 10), ("scal", 10), ("bwd", 10), ("fwd", 2),
            ("scal", 2), ("bwd", 2)]


def ptxas_report(kernels):
    """Print ptxas's lines (-Xptxas -v: registers, shared memory, spills)
    of the named __global__ functions of the build."""
    entry = None
    for line in open(_build.ptxas_log_path()).read().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = next((k for k in kernels if k in m.group(1)), None)
            continue
        if entry and ("registers" in line or "spill" in line):
            print(f"# ptxas {entry}: {line.split(':', 1)[-1].strip()}",
                  flush=True)


def attention_sweep_phase(gen):
    """Every stencil-attention launch (attention_launches) against its
    plain version within 1e-4 of the largest value, on inputs on a 1/8
    grid (every dot product exact in f32, so both sides take the same
    side of the relu kink), launched twice with bitwise-equal results,
    then timed per launch over ATT_REPEAT launches back to back beside
    its byte bound (each input read once, each output written once); at
    batch 2 StencilAttentionFunction's gradients
    against autograd through the plain forward. Returns the records."""
    wa = window_attention
    ptxas_report(ATTENTION_RING_KERNELS)
    # bytes a voxel moves: theta, phi, g in, out (forward); those, ybar
    # in, four statistics out; those four and the statistics in, three
    # gradients out
    voxel_bytes = {"fwd": 128, "scal": 144, "bwd": 240}
    rel = lambda yp: 1e-4 * yp.abs().max().item()  # noqa: E731
    records = []
    for kind, B in attention_launches():
        th, ph, g, yb = (torch.round(torch.randn(
            B, 64, 64, 64, 8, generator=gen, device="cuda") * 8) / 8
            for _ in range(4))
        args = (th, ph, g) if kind == "fwd" else (th, ph, g, yb)
        fn, plain = {"fwd": (wa.stencil_attention, wa.stencil_attention_plain),
                     "scal": (wa.stencil_attention_scal,
                              wa.stencil_attention_scal_plain),
                     "bwd": (wa.stencil_attention_bwd,
                             wa.stencil_attention_bwd_plain)}[kind]
        if kind == "bwd":
            args = args + (wa.stencil_attention_scal_plain(*args),)
        with torch.no_grad():
            y, yp, y2 = (_outputs(f(*args)) for f in (fn, plain, fn))
            torch.cuda.synchronize()
            err = max((a - b).abs().max().item() for a, b in zip(y, yp))
            allowed = min(rel(b) for b in yp)
            same = all(torch.equal(a, b) for a, b in zip(y, y2))
            ms = cuda_ms(lambda: [fn(*args) for _ in range(ATT_REPEAT)]) \
                / ATT_REPEAT
        bound_ms, _ = bound(B * 64 ** 3 * voxel_bytes[kind], 0.0, F32_FLOPS)
        plan = (wa.fwd_plan if kind == "fwd" else wa.bwd_plan)(
            B, 64, 64, 64) if kind != "scal" else None
        tag = f"{kind} {B}x64^3"
        rec = {"kind": kind, "batch": B, "max_abs_err": err,
               "allowed": allowed, "ms": ms, "bound_ms": bound_ms,
               "share": bound_ms / ms,
               "tile": list(plan["run"]) if plan else None,
               "smem": plan["smem"] if plan else None}
        line = (f"# attention sweep {tag}: max_abs_err {err:.3g} (allowed "
                f"{allowed:.3g}), repeat "
                f"{'bitwise equal' if same else 'DIFFERS'}; ms {ms:.4f}, "
                f"bound {bound_ms:.4f} ms (bytes), "
                f"{100 * bound_ms / ms:.1f}% of it")
        if plan:
            line += (f"; tile {plan['run']}, {plan['blocks']} blocks, "
                     f"{plan['smem']} bytes of dynamic shared memory")
        print(line, flush=True)
        if not err <= allowed:
            fail(f"attention sweep {tag}: disagrees with its plain version")
        if not same:
            fail(f"attention sweep {tag}: two launches differ bitwise")
        if kind == "bwd" and B == 2:
            leaves = [t.clone().requires_grad_() for t in (th, ph, g)]
            got = torch.autograd.grad(wa.stencil_attention(*leaves), leaves,
                                      yb)
            want = torch.autograd.grad(wa.stencil_attention_plain(*leaves),
                                       leaves, yb)
            for name, a, b in zip(("dtheta", "dphi", "dg"), got, want):
                e = (a - b).abs().max().item()
                print(f"# attention sweep StencilAttentionFunction {name} "
                      f"at batch 2 vs autograd of the plain forward: "
                      f"max_abs_err {e:.3g} (allowed {rel(b):.3g})",
                      flush=True)
                if not e <= rel(b):
                    fail(f"StencilAttentionFunction {name} disagrees with "
                         "autograd at batch 2")
            del leaves, got, want
        records.append(rec)
        del th, ph, g, yb, args, y, yp, y2
        torch.cuda.empty_cache()
    print("# attention sweep " + json.dumps(records), flush=True)
    return records


WRAPPERS = {"conv3x3x3": (conv_stack, "conv3x3x3"),
            "maxpool2": (pool, "maxpool2"),
            "upsample2x": (upsample, "upsample2x"),
            "stencil_attention": (window_attention, "stencil_attention"),
            "conv3x3x3_train": (conv_stack, "conv3x3x3_train"),
            "conv3x3x3_dx": (conv_stack, "conv3x3x3_dx"),
            "conv3x3x3_dw": (conv_stack, "conv3x3x3_dw"),
            "maxpool2_bwd": (pool, "maxpool2_bwd"),
            "upsample2x_bwd": (upsample, "upsample2x_bwd"),
            "stencil_attention_scal": (window_attention,
                                       "stencil_attention_scal"),
            "stencil_attention_bwd": (window_attention,
                                      "stencil_attention_bwd"),
            "conv3d": (conv3d, "conv3d"),
            "conv3d_dx": (conv3d, "conv3d_dx"),
            "conv3d_dw": (conv3d, "conv3d_dw"),
            "maxpool2_bwd_first": (pool, "maxpool2_bwd_first")}
META = {
    "conv3x3x3": ("dram_tpu_torch/kernels/csrc/conv3x3x3.cu",
                  "dram_tpu/core/pallas/fused_stack.py:305"),
    "maxpool2": ("dram_tpu_torch/kernels/csrc/maxpool2.cu",
                 "dram_tpu/core/pallas/pool.py:236"),
    "upsample2x": ("dram_tpu_torch/kernels/csrc/upsample2x.cu",
                   "dram_tpu/core/pallas/upsample.py:202"),
    "stencil_attention": ("dram_tpu_torch/kernels/csrc/stencil_attention.cu",
                          "dram_tpu/core/pallas/window_attention.py:262"),
    "conv3x3x3_train": ("dram_tpu_torch/kernels/csrc/conv3x3x3.cu",
                        "dram_tpu/core/pallas/fused_stack.py:305"),
    "conv3x3x3_dx": ("dram_tpu_torch/kernels/csrc/conv3x3x3.cu",
                     "dram_tpu/core/pallas/fused_stack.py:305"),
    "conv3x3x3_dw": ("dram_tpu_torch/kernels/csrc/conv3x3x3_dw.cu",
                     "dram_tpu/core/pallas/fused_stack.py:388"),
    "maxpool2_bwd": ("dram_tpu_torch/kernels/csrc/maxpool2.cu",
                     "dram_tpu/core/pallas/pool.py:245"),
    "upsample2x_bwd": ("dram_tpu_torch/kernels/csrc/upsample2x.cu",
                       "dram_tpu/core/pallas/upsample.py:149"),
    "stencil_attention_scal": (
        "dram_tpu_torch/kernels/csrc/stencil_attention.cu",
        "dram_tpu/core/pallas/window_attention.py:335"),
    "stencil_attention_bwd": (
        "dram_tpu_torch/kernels/csrc/stencil_attention.cu",
        "dram_tpu/core/pallas/window_attention.py:366"),
    "conv3d": ("dram_tpu_torch/kernels/csrc/conv3x3x3.cu",
               "dram_tpu/core/pallas/conv3d.py:186"),
    # dx: the forward pallas_call on flipped weights, in _vjp_bwd
    "conv3d_dx": ("dram_tpu_torch/kernels/csrc/conv3x3x3.cu",
                  "dram_tpu/core/pallas/conv3d.py:234"),
    "conv3d_dw": ("dram_tpu_torch/kernels/csrc/conv3x3x3_dw.cu",
                  "dram_tpu/core/pallas/conv3d.py:250"),
    # the VJP of flax's nn.max_pool (XLA), the unfused stack's pool
    "maxpool2_bwd_first": ("dram_tpu_torch/kernels/csrc/maxpool2.cu",
                           "dram_tpu/models/blocks.py:384"),
}
# the __global__ functions behind each wrapper (csrc/*.cu)
GLOBALS = {"conv3x3x3": "conv3x3x3_wgmma_kernel",
           "conv3x3x3_dw": "conv3x3x3_dw_wgmma_kernel, colsum_kernel",
           "maxpool2": "maxpool2_kernel", "upsample2x": "upsample2x_kernel",
           "stencil_attention": "stencil_attention_kernel",
           "maxpool2_bwd": "maxpool2_bwd_kernel",
           "upsample2x_bwd": "upsample2x_bwd_kernel",
           "stencil_attention_scal": "stencil_attention_scal_kernel",
           "stencil_attention_bwd": "stencil_attention_bwd_kernel",
           "maxpool2_bwd_first": "maxpool2_bwd_kernel"}
for _k in ("conv3x3x3_train", "conv3x3x3_dx", "conv3d", "conv3d_dx"):
    GLOBALS[_k] = GLOBALS["conv3x3x3"]
GLOBALS["conv3d_dw"] = GLOBALS["conv3x3x3_dw"]
# the kernels each path launches: the chunk-wire inference, the
# st_dram_ref training step and the flagship st_dram_ref_att training step,
# each with the fused conv stack; the flagship's inference and training
# step with the unfused one
TRAIN_KERNELS = ("conv3x3x3_train", "conv3x3x3_dx", "conv3x3x3_dw",
                 "maxpool2", "maxpool2_bwd", "upsample2x", "upsample2x_bwd")
ATTENTION_TRAIN = ("stencil_attention", "stencil_attention_scal",
                   "stencil_attention_bwd")
PATHS = {"pipeline": ("conv3x3x3", "maxpool2", "upsample2x",
                      "stencil_attention"),
         "train": TRAIN_KERNELS,
         "train_att": TRAIN_KERNELS + ATTENTION_TRAIN,
         "pipeline_unfused": ("conv3d", "maxpool2", "upsample2x",
                              "stencil_attention"),
         "train_unfused": ("conv3d", "conv3d_dx", "conv3d_dw", "maxpool2",
                           "maxpool2_bwd_first", "upsample2x",
                           "upsample2x_bwd") + ATTENTION_TRAIN}
# the training golden's step (golden.train_golden_batch, 2 x 48^3) with
# the fused and the unfused stack
PATHS["train_golden"] = PATHS["train_att"]
PATHS["train_golden_unfused"] = PATHS["train_unfused"]


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


def zero_counts():
    for mod, attr in WRAPPERS.values():
        getattr(mod, attr).launches = 0


def path_counts(path, expect=None):
    """Launch counts of `path`'s kernels since zero_counts(); fails when
    one of them never launched, when a count differs from `expect`
    ({name: count}), or when a kernel of no path's list for `path` ran."""
    counts = {k: getattr(*WRAPPERS[k]).launches for k in PATHS[path]}
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        fail(f"kernels never launched on the {path} path: {missing}")
    wrong = {k: (counts[k], n) for k, n in (expect or {}).items()
             if counts[k] != n}
    if wrong:
        fail(f"launches on the {path} path (got, expected): {wrong}")
    stray = {k: getattr(*WRAPPERS[k]).launches for k in WRAPPERS
             if k not in PATHS[path] and getattr(*WRAPPERS[k]).launches}
    if stray:
        fail(f"kernels of another path launched on the {path} path: {stray}")
    return counts


def run_train(settings, label, batch, bench):
    """TRAIN_STEPS steps of `settings` from the flagship's weights on
    `batch`; returns the step-1 loss terms, gradients and buffers."""
    first = {}

    def on_step(i, step, r):
        if i == 0:
            first["grads"] = {n: p.grad.detach().float().clone()
                              for n, p in step.model.named_parameters()}
            first["buffers"] = {n: b.detach().clone()
                                for n, b in step.model.named_buffers()}

    out = train_steps(settings, TRAIN_STEPS, [batch], device="cuda",
                      weights_path=bench, on_step=on_step)
    for i in range(TRAIN_STEPS):
        (reg, seg), ms = out["losses"][i], out["ms"][i]
        print(f"# train {label} step {i + 1}: reg {reg:.6g} seg {seg:.6g} "
              f"total {out['loss'][i]:.6g}; ms forward {ms['forward']:.1f} "
              f"backward {ms['backward']:.1f} optimizer "
              f"{ms['optimizer']:.1f}; peak {out['peak_mib'][i]:.0f} MiB",
              flush=True)
        if not np.isfinite(out["losses"][i] + [out["loss"][i]]).all():
            fail(f"train {label} step {i + 1}: non-finite loss")
    for n, g in first["grads"].items():
        if not torch.isfinite(g).all():
            fail(f"train {label}: non-finite gradient of {n}")
    first["losses"] = out["losses"][0]
    return first


def zero_in_exact_arithmetic(name):
    """The tap heads' 1x1x1 conv biases: a train-mode BatchNorm follows
    and subtracts the batch mean, so their gradient is zero in exact
    arithmetic and holds only rounding."""
    return name.startswith("reshape_") and name.endswith("conv.bias")


def check_head_grads(run, label):
    """Every PCM and tap-head parameter gets a non-zero, finite gradient
    (the conv biases of zero_in_exact_arithmetic a finite one): no
    gradient is dropped on the way to them."""
    heads = {n: g for n, g in run["grads"].items()
             if n.startswith(("attention_module.", "reshape_"))}
    if len(heads) != 16:
        fail(f"train {label}: expected 16 PCM and tap-head parameters, got "
             f"{sorted(heads)}")
    size = {n: g.abs().max().item() for n, g in heads.items()}
    live = {n: v for n, v in size.items() if not zero_in_exact_arithmetic(n)}
    low = min(live, key=live.get)
    print(f"# train {label}: gradients of the {len(heads)} PCM and tap-head "
          f"parameters finite; smallest largest-|g| {live[low]:.3g} ({low}); "
          "tap-head conv biases (zero in exact arithmetic) "
          + ", ".join(f"{n} {v:.3g}" for n, v in size.items()
                      if zero_in_exact_arithmetic(n)), flush=True)
    if not live[low] > 0:
        fail(f"train {label}: zero gradient of {low}")


def compare_train(k, p, initial, label="train"):
    """Kernel run vs plain run of the training step: step-1 loss terms,
    every parameter gradient (but those zero in exact arithmetic), and
    the BatchNorm batch statistics that step 1 folded into the running
    ones (r1 = 0.9 r0 + 0.1 batch)."""
    rel = [abs(a - b) / max(abs(b), 1e-30)
           for a, b in zip(k["losses"], p["losses"])]
    cos, rl2 = {}, {}
    for n, gp in p["grads"].items():
        if zero_in_exact_arithmetic(n):
            continue
        gk = k["grads"][n]
        cos[n] = (torch.dot(gk.flatten(), gp.flatten())
                  / (gk.norm() * gp.norm()).clamp(min=1e-30)).item()
        rl2[n] = ((gk - gp).norm() / gp.norm().clamp(min=1e-30)).item()
    bn = {}
    for n, r1 in p["buffers"].items():
        r0 = initial[n].to(r1.device)
        bp, bk = (r1 - 0.9 * r0) / 0.1, (k["buffers"][n] - 0.9 * r0) / 0.1
        bn[n] = ((bk - bp).norm() / bp.norm().clamp(min=1e-30)).item()
    wc, wr, wb = (min(cos, key=cos.get), max(rl2, key=rl2.get),
                  max(bn, key=bn.get))
    print(f"# {label} kernels vs plain on the card: step-1 loss terms "
          f"{k['losses']} vs {p['losses']} (rel {max(rel):.3g}, allowed "
          f"{LOSS_RTOL}); gradients of {len(cos)} parameters: worst cosine "
          f"{cos[wc]:.6f} ({wc}, allowed {GRAD_COS_MIN}), worst relative "
          f"L2 {rl2[wr]:.3g} ({wr}, allowed {GRAD_REL_L2}); BatchNorm batch "
          f"statistics after step 1: worst relative L2 {bn[wb]:.3g} ({wb}, "
          f"allowed {BN_REL_L2})", flush=True)
    heads = [n for n in cos if n.startswith(("attention_module.",
                                             "reshape_"))]
    if heads:
        rest = [n for n in cos if n not in heads]
        for group, names in (("PCM and tap heads", heads),
                             ("backbone", rest)):
            gc, gr = min(names, key=cos.get), max(names, key=rl2.get)
            print(f"# {label} {group}: worst cosine {cos[gc]:.6f} ({gc}), "
                  f"worst relative L2 {rl2[gr]:.3g} ({gr})", flush=True)
    if not (max(rel) <= LOSS_RTOL and cos[wc] >= GRAD_COS_MIN
            and rl2[wr] <= GRAD_REL_L2 and bn[wb] <= BN_REL_L2):
        fail(f"{label} step with the kernels disagrees with the plain run")


def train_phases(settings, name, bench, initial_of, launches, extra=None,
                 expect=None):
    """Phases `name` and `name plain`: TRAIN_STEPS steps of `settings`
    with the kernels (launch counts of PATHS[name] zeroed just before,
    read just after), the same steps with the plain versions, and the
    gate between them. `extra(batch)` runs first in the kernel phase;
    `initial_of()` gives the start's buffers; `expect` the launches per
    step. Returns both runs."""
    label = name.replace("_", " ")
    tag = label[len("train "):] + " " if label != "train" else ""
    with phase(label, LIMITS[name]):
        t0 = time.perf_counter()
        batch = train_batch(SEED, batch=settings.TRAIN_BATCH_SIZE,
                            size=settings.RESAMPLE_SIZE[0],
                            window=(settings.WINDOWING_MIN,
                                    settings.WINDOWING_MAX))
        print(f"# {label} batch: {batch['#image'].shape} chunks, ctss "
              f"{batch['meta']['ctss']}, made in "
              f"{(time.perf_counter() - t0) * 1e3:.0f} ms", flush=True)
        if extra is not None:
            extra(batch)
        zero_counts()
        k_run = run_train(settings, tag + "kernels", batch, bench)
        launches[name] = path_counts(name, {
            k: n * TRAIN_STEPS for k, n in (expect or {}).items()})
        print(f"# launches over the {TRAIN_STEPS} {tag}training steps: "
              f"{launches[name]}", flush=True)
        torch.cuda.empty_cache()

    with phase(f"{label} plain", LIMITS[name + "_plain"]):
        print("# plain versions: f32 math, TF32 off "
              "(cudnn.allow_tf32 = cuda.matmul.allow_tf32 = False)",
              flush=True)
        with plain_versions():
            p_run = run_train(settings, tag + "plain versions", batch, bench)
        compare_train(k_run, p_run, initial_of(), label)
        torch.cuda.empty_cache()
    return k_run, p_run


def pseudo_label_count(batch, bench):
    """Voxels the flagship's pseudo labels mark on `batch` (its dense head
    in eval mode): the seg term's positives."""
    params, bs = weights.load_bench_weights(bench)
    m = weights.load_into(DC3DATGeneric(dtype=torch.bfloat16), params,
                          bs).eval().cuda()
    with torch.no_grad():
        x = torch.from_numpy(batch["#image"][..., None]).cuda()
        dense, _ = m.compute_features(x)
        pseudo = pseudo_labels(
            dense, torch.from_numpy(batch["#lobe_reference"][..., None]).cuda(),
            torch.from_numpy(batch["#lesion_reference"][..., None]).cuda(),
            torch.tensor(batch["meta"]["ctss"], device="cuda"))
        per = pseudo.sum(dim=(1, 2, 3, 4)).long().tolist()
    cand = batch["#lesion_reference"].reshape(len(per), -1).sum(1).tolist()
    print(f"# pseudo-label voxels per chunk of the flagship on this batch: "
          f"{per} (lesion candidates {cand})", flush=True)
    if sum(per) == 0:
        fail("the pseudo labels are empty on the training batch: the seg "
             "term would train toward 0 only")


def compare_masks(a, b, label):
    """Mask agreement of two scans of SCAN_SHAPE: Dice of pred and post >=
    0.995 and the same Otsu bin, the repo's gate; prints the readings and
    the largest difference of the per-lobe ratios."""
    d_pred, d_post = dice(a["pred"], b["pred"]), dice(a["post"], b["post"])
    same_bin = round(a["threshold"] * 255) == round(b["threshold"] * 255)
    d_ratio = np.abs(np.asarray(a["ratios"]) - np.asarray(b["ratios"])).max()
    print(f"# {label}: dice pred {d_pred:.6f} post {d_post:.6f}, otsu "
          f"{a['threshold']:.6f} vs {b['threshold']:.6f}, ratios max diff "
          f"{d_ratio:.3g}", flush=True)
    if d_pred < 0.995 or d_post < 0.995 or not same_bin:
        fail(f"{label}: the masks disagree")


def sha256(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def numpy_blas():
    """numpy's version and the BLAS (with the kernel it picked) behind its
    float32 matmuls, which the host prep's resample runs on."""
    blas = np.show_config(mode="dicts")["Build Dependencies"]["blas"]
    config = " ".join(str(blas.get("openblas configuration", "")).split())
    return f"numpy {np.__version__}, {blas.get('name')} " \
        f"{blas.get('version')} ({config})"


def block_means(x80_bits, block=8):
    """Means of the prepped chunk values (bf16 bits -> f32) over block^3
    cubes: (n_lobes, 80 / block, ...) f32, the golden's fingerprint of the
    model input."""
    x = torch.from_numpy(np.ascontiguousarray(x80_bits).view(np.int16)) \
        .view(torch.bfloat16).double().numpy()
    n, d = x.shape[0], x.shape[1] // block
    return x.reshape(n, d, block, d, block, d, block).mean(
        axis=(2, 4, 6)).astype(np.float32)


# the golden's chunk fingerprint may move by one HU of the HU window:
# the NumPy prep's float32 resample is a BLAS matmul, whose rounding
# depends on the host's BLAS kernel (+-1 HU at some iso voxels between
# two hosts; ROADMAP.md, Queue 3)
BLOCK_MEAN_ATOL = 1.0 / (WINDOW[1] - WINDOW[0])


def golden_phase(draw, prepc, runs):
    """Hold `runs` (label -> scan output) against dram_tpu's masks of the
    same scan (GOLDEN, tools/make_port_golden.py). Fails unless this host
    drew the golden's scan (`draw`: scan, lobe, vessel; sha256), its lobe
    bits equal the golden's (sha256) and its chunk values agree with the
    golden's within BLOCK_MEAN_ATOL in every 8^3 block mean (the chunk
    bits' sha256 is printed: it differs where the host's BLAS rounds the
    resample differently)."""
    gold = np.load(os.path.join(ROOT, *GOLDEN.split("/")))
    if sha256(*draw) != str(gold["draw_sha256"]):
        fail("golden: this host drew another scan (sha256 of the synthetic "
             "scan, lobe and vessel arrays differs from the golden's)")
    if sha256(prepc["lobe_bits"]) != str(gold["lobe_sha256"]):
        fail("golden: the prepped lobe bits differ from the golden's")
    dmean = np.abs(block_means(prepc["x80_bits"])
                   - gold["x80_block_means"]).max()
    same = sha256(prepc["x80_bits"]) == str(gold["x80_sha256"])
    print(f"# golden {GOLDEN} (jax {gold['jax_version']}, "
          f"{gold['numpy_blas']}); this host: {numpy_blas()}", flush=True)
    print(f"# golden: the same draw and lobe bits; chunk bits "
          f"{'identical' if same else 'not bit-identical'} (sha256), "
          f"8^3 block means within {dmean:.3g} (allowed "
          f"{BLOCK_MEAN_ATOL:.3g})", flush=True)
    if not dmean <= BLOCK_MEAN_ATOL:
        fail("golden: the prepped chunks differ from the golden's")
    n = int(np.prod(SCAN_SHAPE))
    ref = {k: np.unpackbits(gold[f"{k}_bits"])[:n].reshape(SCAN_SHAPE)
           .astype(bool) for k in ("pred", "post")}
    ref["threshold"], ref["ratios"] = float(gold["threshold"]), gold["ratios"]
    print(f"# golden: threshold {ref['threshold']:.6f} (bin "
          f"{int(gold['otsu_bin'])}), pred voxels {int(ref['pred'].sum())}, "
          f"post voxels {int(ref['post'].sum())}", flush=True)
    for label, out in runs.items():
        compare_masks(out, ref, f"{label} vs dram_tpu's golden")


def golden_step(settings, bench):
    """One step of `settings` with the kernels (bf16 activations, the f32
    image wire) on the training golden's batch from the trained tree:
    (loss terms, golden.summarize fields)."""
    batch = golden.train_golden_batch()
    got = {}

    def on_step(i, step, r):
        m = step.model
        got["grads"] = {n: p.grad.detach().double().cpu().numpy()
                        for n, p in m.named_parameters()}
        got["params"] = {n: p.detach().double().cpu().numpy()
                         for n, p in m.named_parameters()}
        got["buffers"] = {n: b.detach().double().cpu().numpy()
                          for n, b in m.named_buffers()}
    out = train_steps(with_settings(settings, TRAIN_WIRE="f32"), 1, [batch],
                      device="cuda", weights_path=bench, on_step=on_step)
    initial = {n: t.double().numpy() for n, t in weights.from_jax(
        *weights.load_bench_weights(bench)).items()}
    for n, g in got["grads"].items():
        if not np.isfinite(g).all():
            fail(f"train golden: non-finite gradient of {n}")
    return np.asarray(out["losses"][0]), golden.summarize(
        got["grads"], got["buffers"], initial, got["params"], initial)


def golden_readings(losses, fields, gold, label):
    """Hold one kernel step against dram_tpu's float64 step (the golden):
    loss terms (relative, LOSS_RTOL), every gradient's seeded projections
    (cosine, GRAD_COS_MIN; relative L2 per group, GOLDEN_REL_L2; the tap
    heads' conv biases, zero in exact arithmetic, are printed), the
    BatchNorm batch statistics (relative L2, GOLDEN_BN_REL_L2). Prints
    the readings, the update's as information; returns the failures."""
    read = golden.readings(fields, gold)
    rel = np.abs(losses - gold["losses"]) / np.abs(gold["losses"])
    proj = {k.split("/", 1)[1]: v for k, v in read.items()
            if k.startswith("grad_proj/")}
    live = {n: v for n, v in proj.items()
            if not golden.zero_in_exact_arithmetic(n)}
    bn = {k.split("/", 1)[1]: v[0] for k, v in read.items()
          if k.startswith("bn/")}
    upd = {k.split("/", 1)[1]: v for k, v in read.items()
           if k.startswith("update_proj/")
           and not golden.zero_in_exact_arithmetic(k.split("/", 1)[1])}
    wb = max(bn, key=bn.get)
    wu = max(upd, key=lambda n: upd[n][0])
    heads = [n for n in live if n.startswith(("attention_module.",
                                              "reshape_"))]
    groups = {"backbone": [n for n in live if n not in heads],
              "PCM and tap heads": heads}
    print(f"# train golden {label} vs dram_tpu's float64 step: loss terms "
          f"{losses.tolist()} vs {gold['losses'].tolist()} (rel "
          f"{rel.max():.3g}, allowed {LOSS_RTOL}); BatchNorm batch "
          f"statistics of {len(bn)}: worst relative L2 {bn[wb]:.3g} ({wb}, "
          f"allowed {GOLDEN_BN_REL_L2})", flush=True)
    bad = []
    for group, names in groups.items():
        gc = min(names, key=lambda n: live[n][1])
        gr = max(names, key=lambda n: live[n][0])
        print(f"# train golden {label} {group}: gradient projections of "
              f"{len(names)} parameters: worst cosine {live[gc][1]:.6f} "
              f"({gc}, allowed {GRAD_COS_MIN}), worst relative L2 "
              f"{live[gr][0]:.3g} ({gr}, allowed {GOLDEN_REL_L2[group]})",
              flush=True)
        if not (live[gc][1] >= GRAD_COS_MIN
                and live[gr][0] <= GOLDEN_REL_L2[group]):
            bad.append(f"{group} gradients")
    print(f"# train golden {label} (information): Adam update projections "
          f"worst relative L2 {upd[wu][0]:.3g} ({wu}), cosine "
          f"{upd[wu][1]:.6f}; tap-head conv bias gradients (zero in exact "
          f"arithmetic) "
          + ", ".join(f"{n} |proj| {v[0]:.3g}" for n, v in proj.items()
                      if golden.zero_in_exact_arithmetic(n)), flush=True)
    if not rel.max() <= LOSS_RTOL:
        bad.append("loss terms")
    if not bn[wb] <= GOLDEN_BN_REL_L2:
        bad.append("BatchNorm statistics")
    return bad


def train_golden_phase(bench, launches, configs):
    """The kernel step at full width on the training golden's batch,
    against dram_tpu's float64 step (GOLDEN: tools/make_port_train_golden.
    py), for each (path, settings) of `configs`, launch counts zeroed
    just before each step and read just after."""
    with np.load(golden.TRAIN_GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    if golden.batch_sha256(golden.train_golden_batch()) \
            != str(gold["batch_sha256"]):
        fail("train golden: this host made another batch (sha256 differs "
             "from the golden's)")
    print(f"# train golden {os.path.relpath(golden.TRAIN_GOLDEN, ROOT)} "
          f"(jax {gold['jax_version']}): batch {golden.TRAIN_BATCH} x "
          f"{golden.TRAIN_SIZE}^3, seed {golden.TRAIN_SEED}, the same "
          "sha256", flush=True)
    failed = []
    for path, settings in configs:
        zero_counts()
        losses, fields = golden_step(settings, bench)
        launches[path] = path_counts(path)
        label = path[len("train_golden"):].strip("_") or "fused"
        bad = golden_readings(losses, fields, gold, label)
        failed += [f"{label}: {b}" for b in bad]
        torch.cuda.empty_cache()
    if failed:
        fail(f"train golden: the kernel step disagrees with dram_tpu's "
             f"float64 step ({', '.join(failed)})")


def unfused_vs_fused(f, u):
    """Information, no gate: the unfused and the fused kernel runs of the
    flagship step compute one function with two rounding configurations;
    their step-1 loss terms and gradients side by side."""
    rel = [abs(a - b) / max(abs(b), 1e-30)
           for a, b in zip(u["losses"], f["losses"])]
    rl2 = {n: ((u["grads"][n] - g).norm() / g.norm().clamp(min=1e-30)).item()
           for n, g in f["grads"].items() if not zero_in_exact_arithmetic(n)}
    worst = max(rl2, key=rl2.get)
    print(f"# unfused vs fused kernel runs (information): step-1 loss terms "
          f"{u['losses']} vs {f['losses']} (rel {max(rel):.3g}); gradients "
          f"of {len(rl2)} parameters: worst relative L2 {rl2[worst]:.3g} "
          f"({worst}), median {float(np.median(list(rl2.values()))):.3g}",
          flush=True)


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
        zero_counts()
        a = run_scan(pipe, prepc, False, "kernels, cold")
        b = run_scan(pipe, prepc, True, "kernels, heatmap")
        launches = {"pipeline": path_counts("pipeline")}
        print(f"# launches over the two scans: {launches['pipeline']}",
              flush=True)
        for k in ("pred", "post"):
            if not np.array_equal(a[k], b[k]):
                fail(f"{k} differs between the host and device post rule")
        warm = run_scan(pipe, prepc, False, "kernels, warm")

    with phase("plain", LIMITS["plain"]):
        with plain_versions():
            p = run_scan(pipe, prepc, False, "plain versions")
        if not warm["pred"].any():
            fail("empty pred mask")
        compare_masks(warm, p, "kernels vs plain on the card")

    unfused = with_settings(st_dram_ref_att, USE_FUSED_STACK=False)
    with phase("pipeline unfused", LIMITS["pipeline_unfused"]):
        upipe = FastScanPipeline(weights.load_into(
            build_model(unfused, torch.bfloat16), params, batch_stats),
            device="cuda")
        zero_counts()
        run_scan(upipe, prepc, False, "unfused kernels, cold")
        uwarm = run_scan(upipe, prepc, False, "unfused kernels, warm")
        launches["pipeline_unfused"] = path_counts("pipeline_unfused",
                                                   {"conv3d": 2 * 14})
        print(f"# launches over the two unfused scans: "
              f"{launches['pipeline_unfused']}", flush=True)
        compare_masks(uwarm, warm, "unfused vs fused kernels on the card")

    with phase("plain unfused", LIMITS["plain_unfused"]):
        with plain_versions():
            up = run_scan(upipe, prepc, False, "unfused plain versions")
        compare_masks(uwarm, up, "unfused kernels vs plain on the card")

    with phase("golden", LIMITS["golden"]):
        golden_phase((scan, lobe, vessel), prepc,
                     {"fused kernels": warm, "unfused kernels": uwarm})

    del upipe
    del pipe, model, prepc
    torch.cuda.empty_cache()
    res.update(train_kernel_phases(gen))
    torch.cuda.empty_cache()
    res.update(unfused_kernel_phases(gen))
    torch.cuda.empty_cache()
    with phase("conv sweep", LIMITS["conv_sweep"]):
        conv_sweep_phase(gen)
    torch.cuda.empty_cache()
    with phase("upsample sweep", LIMITS["upsample_sweep"]):
        upsample_sweep_phase(gen)
    torch.cuda.empty_cache()
    with phase("attention sweep", LIMITS["attention_sweep"]):
        attention_sweep_phase(gen)
    torch.cuda.empty_cache()

    bench = os.path.join(ROOT, "assets", "bench_weights.ckpt.xz")
    train_phases(st_dram_ref, "train", bench, lambda: dict(
        weights.load_backbone(DC3D(stacking=st_dram_ref.MODEL["stacking"]),
                              bench).named_buffers()), launches)

    with phase("eval conv under grad", LIMITS["eval_conv_grad"]):
        eval_conv_grad_phase(gen)

    def flagship_buffers():
        return dict(weights.load_into(
            DC3DATGeneric(), *weights.load_bench_weights(bench))
            .named_buffers())
    k_run, p_run = train_phases(
        st_dram_ref_att, "train_att", bench, flagship_buffers, launches,
        extra=lambda batch: pseudo_label_count(batch, bench))
    check_head_grads(k_run, "att kernels")
    check_head_grads(p_run, "att plain versions")
    del p_run
    torch.cuda.empty_cache()

    uk_run, up_run = train_phases(
        unfused, "train_unfused", bench, flagship_buffers, launches,
        expect={"conv3d": 14, "conv3d_dx": 13, "conv3d_dw": 14,
                "maxpool2_bwd_first": 3})
    check_head_grads(uk_run, "unfused kernels")
    check_head_grads(up_run, "unfused plain versions")
    unfused_vs_fused(k_run, uk_run)
    del k_run, uk_run, up_run
    torch.cuda.empty_cache()

    with phase("train golden", LIMITS["train_golden"]):
        train_golden_phase(bench, launches,
                           (("train_golden", st_dram_ref_att),
                            ("train_golden_unfused", unfused)))

    kernels = []
    for k in WRAPPERS:
        by_path = {path: launches[path][k] for path in PATHS
                   if k in PATHS[path]}
        kernels.append({"name": k, "route": "cuda", "source": META[k][0],
                        "replaces": META[k][1], "global": GLOBALS[k],
                        "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **res[k]})
    print("# kernels " + json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

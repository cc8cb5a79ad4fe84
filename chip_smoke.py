#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dram_tpu_torch) once on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each under a faulthandler watchdog that ends a hung run with a
traceback and a non-zero exit:

1. card: the card's name and power limit (nvidia-smi); fails without CUDA.
2. build: nvcc builds the CUDA kernels from dram_tpu_torch/kernels/csrc
   while g++ builds the C++ host prep of dram_tpu_torch/native.
3. one phase per kernel (and per training mode of the conv kernel), at
   its path's largest shape: the kernel against its plain PyTorch version
   on the same inputs (error against the stated tolerance), then
   CUDA-event times (median of 7 after warm-up; the network-entry conv's
   pair, a tenth of a millisecond a launch, per call over 10 back to
   back) of the kernel, the plain version and, where one PyTorch call
   computes the same function, that call (timed here only; the port
   never calls it). The stencil
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
11. the inference engine (after 10's golden, before the sweeps):
   engine, LesionSegTest on the flagship over a RadboudCOVID split of
   three synthetic scans of that shape and a truncated fourth, written
   with the port's MHA codec beside a checkpoint saved by the port from
   the trained weights: every good scan archived at its shape with a
   finite Dice, the truncated one logged and missing, the four forward
   kernels launched (counts zeroed just before, read just after, path
   engine), per-scan wall times of load, prep, pre / model / post and
   archive; a restart over the same output archives and launches
   nothing. engine deploy: the CLI (python3 -m
   dram_tpu_torch.process_pipeline) in deployment mode on the scan of 4,
   whose archived pred mask and heatmap must equal 4's heatmap run
   bitwise (post: the same scan prepped without the vessel mask).
   engine host-stitch: USE_FAST_INFERENCE = False on that scan (each
   lobe alone, batch 1) with the kernels and with the plain versions:
   Dice >= 0.995 and the same Otsu bin; every kernel launch of the first
   lobe's forward against its plain version.
11b. the C++ host prep and the scan wires (after 10's golden, before
   11): host prep prints the g++ build of phase 2 (its version, the
   host CPU's model and which AVX-512 paths were compiled in), times the C++ and NumPy preps on the scan of 4 and on a
   BENCH_SHAPE scan (the bench's 512 x 512 x 400 class), holds the C++
   chunk wire against the NumPy one on both (the same geometry, chunks
   by 8^3 block means, candidate and lobe bits at Dice >= 0.999) and
   prints the digest of a seeded small scan's C++ prep beside the one
   recorded in DIGEST_SHA256 (not a gate); pipeline p12, pipeline w8 and
   pipeline device-resample run process_prepped on both scan wires and
   process on the raw scan with the kernels, launch counts zeroed before
   and read after each: p12 against the chunk wire of the same C++ prep
   at Dice >= 0.995 and the same Otsu bin, w8 and the device resample
   against p12 at pred Dice > 0.98 and ratios within 5e-3; engine w8
   (after 11's engine) runs LesionSegTest with FAST_WIRE = "w8" over the
   engine split, pred masks against the wc run's at Dice > 0.98. The
   golden and the earlier pipeline phases run on the NumPy prep; the
   engine, the CLI and engine deploy's reference run on the C++ prep.
12. conv sweep (after the kernel phases of 3, before 6): ptxas's report
   (registers, spills) and the dynamic shared memory of each Hopper conv
   kernel, and the check that the wgmma kernels' SASS holds HGMMA and no
   HMMA; the same report for the network-entry conv's kernels
   (csrc/conv3x3x3_c1.cu: registers, spills, shared memory, blocks per
   SM, SASS instruction counts, HMMA present); then every conv launch of
   the flagship training step (14 forward, 13 dx, 14 dW; conv_shapes,
   read from a meta-device DC3D) in the mode the step runs it in, the
   network-entry conv's forward and dW on the c1 kernels, and that conv's
   eval (the scan's) and raw (the unfused stack's) forwards: at batch 2
   against its plain version (outputs within 2^-7 of the largest,
   statistics within stats_tol, dW within 1e-3), launched twice with
   bitwise-equal results; at batch 10 (the eval forward at 5, the scan's
   batch) its time, TFLOP/s and share of the bound beside cuDNN's time
   for the same conv (the c1 launches and their cuDNN calls timed over
   C1_REPEAT back to back, as the step issues them).
13. upsample sweep (after 12): every upsample launch, forward and adjoint,
   of the scan (batch 5), the flagship step (batch 10) and the training
   golden's step (batch 2 x 48^3), each against its plain version (2^-7
   of the largest) and launched twice with bitwise-equal results; at
   batch 5 and 10 its time, byte bound and share of it beside the
   library call (F.interpolate / aten.upsample_trilinear3d_backward).
14. attention sweep (after 13): ptxas's report (registers, spills) of the
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
15. train golden (last): the flagship's kernel step, fused and unfused, at
   the published widths and bf16 activations on the training golden's
   batch (golden.train_golden_batch, 2 x 48^3, -300 HU), held against
   dram_tpu's float64 step (tools/make_port_train_golden.py): loss terms
   and every gradient's cosine at the train gate's limits; the gradients'
   relative L2 (per group) and the BatchNorm batch statistics at the
   golden's own limits (GOLDEN_REL_L2, GOLDEN_BN_REL_L2), placed between
   sound and broken kernels' readings; launch counts zeroed before each
   step and read after (paths train_golden, train_golden_unfused).
16. train epochs (after 15): the training CLI's main (python3 -m
   dram_tpu_torch.train) on the flagship's settings at full width (bf16,
   batch 10, 80^3 chunks, four loader threads) over make_synthetic_dataset's
   four scans of 160 x 192 x 192 and their lobe chunks, from the trained
   tree: two epochs of ~4 steps, each validated (the chunk wire's prep and
   process_chunks_val) and checkpointed. Gates: finite losses, records.csv
   in dram_tpu's columns, 0.ckpt and 1.ckpt, the scheduler stepped twice
   and the lr at base * gamma^2, every kernel of the train_epochs path
   (the flagship step's and the chunk wire's forward) launched and no
   other (counts zeroed just before, read just after). Per epoch:
   tr_data_time and tr_batch_time (s a step), steps / s, the validation's
   prep and process_chunks_val ms, the checkpoint's save ms, peak MiB;
   the digest of epoch 0's sampled chunk uids beside EPOCH_UIDS_SHA256
   (not a gate).
17. train val paths: a runner reloaded from the trained tree validates
   by the fast path and by the host-stitch loop (batch-1 forwards): the
   same label and ratios within VAL_RATIO_RTOL (placed between sound and
   broken epilogues by tools/val_gate_mutants.py); the model is back in
   train mode after each validation.
18. train resume: a runner with RELOAD_CHECKPOINT (model, optimizer,
   metrics) holds 1.ckpt's parameters, BatchNorm buffers, Adam state and
   scheduler bitwise, as the first run left them; NUM_EPOCHS = 3 then
   trains epochs 1 and 2 (the loop restarts the checkpoint's epoch, as
   dram_tpu's does) and writes 2.ckpt.

19. pipeline generic (after 10's golden): variant A, the flagship with a
   k = 5, connectivity-2, self-loop PCM (98 offsets, asymmetric, halo 2)
   of widths F = 16, G = 4 (a 33-channel PCM input), the trained
   backbone under fresh tap heads and PCM (HeNorm from RANDOM_SEED): the
   scan of 4 through process_chunks with the kernels (the generic
   attention forward, not the plane ring) and with the plain versions,
   pred Dice >= 0.99.
20. generic attention (after 14): ptxas's report of the generic
   stencil-attention kernels (csrc/stencil_attention_generic.cu, the
   plane-ring forward and the statistics pass;
   csrc/stencil_attention_generic_bwd.cu, the gradient pass's two plane
   rings), per instantiation, then each pass at every case of
   GENERIC_CASES (k = 3 connectivity 1 and 3, k = 5 connectivity 2, k = 7
   connectivity 1, all with a self loop; widths (16, 4), (33, 1), (8, 8)
   and (64, 64); 64^3 and a ragged 37 x 45 x 53 at halo 3, on a 1/8 grid;
   batch 2, and variant A's batch 10): each plane-ring launch's plan
   (tile, sets, ring, threads, shared memory, blocks an SM), then each
   pass against its plain version (1e-4 of the largest), launched twice
   bitwise equal, timed per launch over 10 back to back beside its
   bound; at batch 2 StencilAttentionFunction's gradients against
   autograd through the plain forward (1e-4).
21. train generic / train geo / train variant b (after 10's unfused
   training, each with its plain phase and the train gate, the same
   start and generator seeds on both sides): variant A's 3 steps from
   the trained backbone (the generic kernels, not the plane ring); its
   second PCM with the positional encoding (merge type
   scaled_dot_product_geo_relu, p_enc_dim 24, geo_f_dim 8), one step on
   the plain PCM path; variant B, 'in' norms, PReLU, dropout 0.1, HeNorm
   fan_out, AdamW (weight decay 1e-4) with an attention_module group at
   lr 1e-3 and IntRegAffRefineLoss with the rescale pool 64 / 80 / 96
   (reseeded a step as the epoch loop does), 3 steps from INITIALIZER on
   the unfused stack's kernels, its peak MiB; variant B's gate at its own
   limits (TRAIN_LIMITS: its bf16 steps read rounding noise above the
   others').
22. variant b epochs (after 18): the training CLI's main on variant B
   over the dataset of 16, one epoch (validated, 0.ckpt, the optimizer
   in dram_tpu's multi_transform layout, each group's lr decayed), then
   a resume whose optimizer state equals 0.ckpt's bitwise, training
   epochs 0 and 1 (the checkpoint's epoch restarts) and writing 1.ckpt;
   per epoch the times and peak MiB.
23. engine shard (after 11's host-stitch phase): LesionSegTest with
   SHARD_SCANS = 2 over the engine split, two scans in flight on two
   threads, on cuda:0 twice (two cards where two are visible): masks,
   post masks, heatmaps and records equal to the serial engine phase's
   bit for bit; the chunk wire's forward kernels launched (path
   engine_shard).
24. train dp / train dp pad (after 22): DP_WORLD = 2 ranks, processes
   spawned from this script, join a gloo group through torchrun's
   environment (core/mesh.py: NCCL refuses two ranks on one card) and
   run the flagship's 3 steps from its trained tree on their 5 rows of
   the global batch (train att's 10 x 80^3; then 9 rows padded to 10 by
   mesh.pad_batch with one wrap-around row of weight 0), every kernel of
   the train_att path launched in each rank (counts zeroed before, read
   after; path train_dp). Each is held against the one-process step on
   the same padded batch and weights, dram_tpu's rank-local tap-head
   statistics emulated (rank_local_norms): the ranks' parameters bitwise
   equal; every step's loss terms; step 1's gradients after the
   cross-rank mean and BatchNorm statistics at the train gate's limits;
   each step's parameters at DP_UPDATE_REL_L2 of the update (placed by
   tools/train_gate_mutants.py --dp). Per rank: step ms and peak MiB.
   Two ranks share one card: no number here is a multi-GPU speed-up.
25. pcm sharded / overlap tile (after 24, one spawn of the ranks):
   pcm_sharded of the flagship's PCM (batch 5, 64^3, F = G = 8) over the
   ranks (the plain path on each rank's block and halo) against the
   unsharded PCM on the plane-ring kernel (1e-4 of the largest);
   overlap_tile_infer of the flagship backbone with a local upsample
   (bf16, trained weights) on 2 x 160 x 80 x 80 in 4 tiles of halo 48,
   each rank its share of the windows, against the unsharded forward
   (2^-7 of the largest; path overlap_tile).

Prints a `{"kernels": [...]}` JSON line and, last, the device line
{"ok": true, "device": {...}}. Any failed check exits non-zero before it.
"""

import concurrent.futures
import contextlib
import csv
import faulthandler
import re
import hashlib
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from dram_tpu_torch import golden, native, weights
from dram_tpu_torch.configs import (get_callable_by_name, st_dram_ref,
                                    st_dram_ref_att, with_settings)
from dram_tpu_torch.core import mesh
from dram_tpu_torch.core.ops import binary_cam_np
from dram_tpu_torch.data.datasets import RadboudCOVIDLobeVesselChunk
from dram_tpu_torch.data.hostprep import prep_scan
from dram_tpu_torch.data.io import read_mha, write_mha
from dram_tpu_torch.data.prepare_data import make_synthetic_dataset
from dram_tpu_torch.data.sampler import LobeChunkCTSSSampler
from dram_tpu_torch.data.synth import synth_scan, train_batch
from dram_tpu_torch.infer.engine import LesionSegTest
from dram_tpu_torch.infer.fast import FastScanPipeline, prep_scan_chunks
from dram_tpu_torch.losses.refine import pseudo_labels
from dram_tpu_torch.kernels import (_build, conv3d, conv_stack, pool,
                                    upsample, window_attention)
from dram_tpu_torch.models import DC3D, DC3DATGeneric
from dram_tpu_torch.train import train_steps
from dram_tpu_torch.train.__main__ import main as train_main
from dram_tpu_torch.train.checkpoint import (load_checkpoint,
                                             newest_checkpoint,
                                             optimizer_state_tree,
                                             save_checkpoint)
from dram_tpu_torch.train.chunk_train import LesionSegChunkTrain
from dram_tpu_torch.train.trainer import build_model, pack_train_batch
from dram_tpu_torch.utils import Settings

ROOT = os.path.dirname(os.path.abspath(__file__))
LIMITS = {"card": 30, "build": 180, "kernel": 60, "weights": 60,
          "pipeline": 120, "plain": 120, "train": 300, "train_plain": 300,
          "eval_conv_grad": 30, "train_att": 300, "train_att_plain": 300,
          "pipeline_unfused": 120, "plain_unfused": 120, "golden": 60,
          "train_unfused": 300, "train_unfused_plain": 300,
          "conv_sweep": 240, "upsample_sweep": 120, "attention_sweep": 120,
          "train_golden": 240, "engine": 300, "engine_deploy": 180,
          "engine_stitch": 300, "host_prep": 300, "pipeline_wire": 120,
          "engine_w8": 300, "train_epochs": 300, "train_val_paths": 120,
          "train_resume": 240, "generic_attention": 240,
          "pipeline_generic": 180, "train_generic": 300,
          "train_generic_plain": 300, "train_geo": 240,
          "train_geo_plain": 240, "train_variant_b": 300,
          "train_variant_b_plain": 300, "variant_b_epochs": 420,
          "engine_shard": 300, "train_dp": 420, "train_dp_pad": 120,
          "pcm_sharded": 240, "overlap_tile": 60}
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 tensor-core
# and f32 CUDA-core flop/s
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
SCAN_SHAPE, SPACING, SEED = (160, 192, 192), (1.25, 0.8, 0.8), 0
SEVERITIES = [3, 4, 2, 5, 3]
WINDOW = (-1000, -700)
# dram_tpu's masks of that scan (tools/make_port_golden.py)
GOLDEN = "dram_tpu_torch/golden/flagship_scan.npz"
TRAIN_STEPS = 3
# the bench's 400-slice scan geometry (bench.py MIXED_GEOMS)
BENCH_SHAPE, BENCH_SPACING = (400, 512, 512), (0.8, 0.7, 0.7)
# the C++ prep's digest (hostprep_digest) of a seeded 48 x 64 x 64 scan
# on an Intel Xeon host with g++ 12.2.0, every AVX-512 path of
# hostprep.cpp compiled in; printed beside this host's (a finding, not a
# gate)
DIGEST_SHAPE = (48, 64, 64)
DIGEST_SHA256 = ("307a62d8f0f3a848474b84e12154d8f85e0ab84b3d1fc8eeb35ca33a"
                 "219d1614")
# kernel run vs plain run of the training step on the card: step-1 loss
# terms (relative), every parameter gradient's cosine and relative L2, and
# the relative L2 of the BatchNorm batch statistics that step 1 folds into
# the running ones. The sound kernels read 7.5e-3 and 4.4e-5 on the last
# two; PERF.md gives the readings of deliberately broken kernels.
LOSS_RTOL, GRAD_COS_MIN, GRAD_REL_L2, BN_REL_L2 = 1e-2, 0.99, 3e-2, 1e-3
# each PReLU slope's gradient on its own (relative error; the slopes are
# also held together as one vector at GRAD_REL_L2): a slope's gradient
# sums x * dy over a whole activation with cancelling signs, where bf16
# rounding moves the smallest sum by 0.105 (variant B's ds_0 on an H100);
# ds_0's gradient lost or at 70% reads 1.0 or 0.373 (PERF.md, the
# variant-B readings of tools/train_gate_mutants.py)
SLOPE_REL = 0.25
# variant B ('in' norms, PReLU, the unfused stack): its bf16 steps read
# rounding noise above both limits. Equally valid accumulation orders of
# the entry conv (tools/entry_conv_orders.py) read ds_0's slope at 0.093,
# 0.198 and 0.291 and the worst other gradient at 0.0272 to 0.0302 (the
# padded wgmma entry conv it replaced: 0.105 and 0.0276), where a float32
# witness puts every bf16 step 0.3 to 0.92 off float32 on that slope and
# ~0.107 on the worst other gradient; the slope's gradient lost, at 70%
# and dw64 read 1.0, 0.373 and 0.183. Its limits sit between the largest
# sound and the smallest broken reading, at their geometric means
# (PERF.md, the variant-B gate readings)
TRAIN_LIMITS = {"train variant b": {"slope_rel": 0.33, "grad_rel_l2": 0.074}}
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


def check_kernel(name, kernel, plain, args, tol, library=None, work=None,
                 repeat=1):
    """Hold kernel(*args) against plain(*args); time kernel, plain and the
    library call (each per call over `repeat` calls back to back). Each
    may return a tensor or a tuple of them; `tol` (or one per output) maps
    a plain output to the allowed max |kernel - plain|. max_abs_err is
    the largest over the outputs."""
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
    def per_call(f):
        return cuda_ms(lambda: [f() for _ in range(repeat)]) / repeat
    ms = per_call(lambda: kernel(*args))
    plain_ms = per_call(lambda: plain(*args))
    library_ms = per_call(library) if library is not None else None
    bound_ms, bound_by = bound(*work(*y))
    print(f"# {name}: ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
          f"{library_ms if library_ms is None else round(library_ms, 4)} "
          f"bound_ms {bound_ms:.4f} ({bound_by})"
          f"{f', per call over {repeat} back to back' if repeat > 1 else ''}",
          flush=True)
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


C1_REPEAT = 10  # back-to-back launches a timing of the c1 kernels


def entry_kernel_phases(gen):
    """The network-entry conv's kernels (csrc/conv3x3x3_c1.cu) at the
    flagship step's shape, ds_0.conv_0 on 10 x 80^3, 1 -> 32: the forward
    in its raw + statistics mode and the weight gradient, each against
    its plain version and beside cuDNN's call, timed over C1_REPEAT
    launches back to back (the step issues them ahead of the card: a
    single call's CUDA-event time would hold the wrapper's host time)."""
    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(dtype)

    res = {}
    V = 10 * 80 ** 3
    x = rnd(10, 80, 80, 80, 1)
    w = rnd(32, 1, 3, 3, 3, dtype=torch.float32, scale=0.2)
    xl = x.permute(0, 4, 1, 2, 3)
    wl = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
    with phase("kernel conv3x3x3_c1", LIMITS["kernel"]):
        y, st = conv_stack.conv3x3x3_c1(x, w, stats=True)
        yp, stp = conv_stack.conv3x3x3_c1_plain(x, w, stats=True)
        check_stats("conv3x3x3_c1", st, stp, stats_tol(yp.float()))
        del y, yp
        res["conv3x3x3_c1"] = check_kernel(
            "conv3x3x3_c1",
            lambda a: conv_stack.conv3x3x3_c1(a, w, stats=True)[0],
            lambda a: conv_stack.conv3x3x3_c1_plain(a, w, stats=True)[0],
            (x,), bf16_tol(2 ** -7),
            library=lambda: F.conv3d(xl, wl, padding=1),
            work=lambda y: (nbytes(x, y) + w.numel() * 4,
                            2.0 * V * 27 * 32, BF16_FLOPS),
            repeat=C1_REPEAT)
    dy = rnd(10, 80, 80, 80, 32)
    dyl = dy.permute(0, 4, 1, 2, 3)
    with phase("kernel conv3x3x3_c1_dw", LIMITS["kernel"]):
        res["conv3x3x3_c1_dw"] = check_kernel(
            "conv3x3x3_c1_dw", conv_stack.conv3x3x3_c1_dw,
            conv_stack.conv3x3x3_c1_dw_plain, (x, dy),
            lambda yp: 1e-3 * yp.abs().max().item(),
            library=lambda: torch.nn.grad.conv3d_weight(
                xl, wl.shape, dyl, padding=1),
            work=lambda dw: (nbytes(x, dy, dw), 2.0 * V * 27 * 32,
                             BF16_FLOPS),
            repeat=C1_REPEAT)
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
        # the conv's operations plus relu(x s + t) on each input element;
        # no single PyTorch call computes the prologue and the conv
        pro_bound, pro_by = bound(
            nbytes(x1, x2) + V * 64 * 2 + w.numel() * 2,
            flops + 3.0 * V * 192, BF16_FLOPS)
        print(f"# conv3x3x3_train prologue + statistics [128|64] -> 64: ms "
              f"{ms:.4f} (raw output + statistics "
              f"{res['conv3x3x3_train']['ms']:.4f}); bound_ms "
              f"{pro_bound:.4f} ({pro_by}); library_ms none", flush=True)

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
            # generic_pass_work's 6F + 4G + 8 flops an edge at F = G = 8
            work=lambda *d: (nbytes(th, ph, g, yb, scal, *d), 88.0 * edges,
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
    return sass


# the network-entry conv's kernels (csrc/conv3x3x3_c1.cu)
C1_KERNELS = ("conv3x3x3_c1_kernel", "conv3x3x3_c1_dw_kernel")
C1_MODES = {"ILi0E": " raw", "ILi1E": " eval", "ILi2E": " statistics"}
SASS_OPS = ("HMMA", "LDS", "LDSM", "LDG", "LDGSTS", "STG", "STS", "SHFL",
            "BAR")


def c1_build_report(sass):
    """ptxas's lines (-Xptxas -v), dynamic shared memory, blocks per SM
    and SASS instruction counts of the network-entry conv's kernels (the
    forward in its raw, eval and statistics modes; the weight gradient):
    each must hold HMMA (mma.sync on the tensor cores)."""
    def tag(fn):
        k = next(k for k in C1_KERNELS if k in fn)
        return k + next((v for m, v in C1_MODES.items() if m in fn), "")
    entry = None
    for line in open(_build.ptxas_log_path()).read().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = tag(m.group(1)) if any(k in m.group(1)
                                          for k in C1_KERNELS) else None
            continue
        if entry and ("registers" in line or "spill" in line):
            print(f"# ptxas {entry}: {line.split(':', 1)[-1].strip()}",
                  flush=True)
    lib = _build.load()
    for k, name in enumerate((" raw", " eval", " statistics", "_dw")):
        print(f"# conv3x3x3_c1{name}: "
              f"{lib.conv3x3x3_c1_smem(k, 32)} bytes of dynamic shared "
              f"memory at Co = 32, {lib.conv3x3x3_c1_occupancy(k, 32)} "
              "blocks of 256 threads per SM", flush=True)
    found = 0
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0].strip()
        if not any(k in name for k in C1_KERNELS):
            continue
        found += 1
        ops = [o.split(".")[0] for o in re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", fn)]
        counts = {o: ops.count(o) for o in SASS_OPS}
        print(f"# sass {tag(name)}: {len(ops)} instructions, " + ", ".join(
            f"{n} {o}" for o, n in counts.items()), flush=True)
        if counts["HMMA"] == 0:
            fail(f"{tag(name)}: no HMMA in the SASS")
    if found != 4:
        fail(f"expected 4 c1 kernels in the SASS, found {found}")


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


# the network-entry conv's other forwards: the scan's eval (batch 5) and
# the unfused stack's raw conv
ENTRY_FORWARDS = [("eval", "ds_0.conv_0", 80, (1, 0), 32, "eval"),
                  ("raw", "ds_0.conv_0", 80, (1, 0), 32, "raw")]


def entry_launches():
    """The network-entry conv's launches of the sweep (the c1 kernels)."""
    return [r for r in flagship_conv_launches()
            if r[1] == "ds_0.conv_0"] + ENTRY_FORWARDS


def conv_sweep_phase(gen, launches=None):
    """Every conv launch of the flagship training step, and the entry
    conv's eval and raw forwards (or the `launches` given): checked at
    batch 2, timed at batch 10 (eval: 5) beside cuDNN. Returns the
    per-launch records."""
    c1_build_report(wgmma_build_report())
    torch.cuda.synchronize()
    records = []
    for kind, name, e, (c1, c2), co, mode in (
            launches or flagship_conv_launches() + ENTRY_FORWARDS):
        recs = {}
        for B in (2, 5 if kind == "eval" else 10):
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
            elif kind == "eval":
                w = rnd(co, ci, 3, 3, 3, scale=(27 * ci) ** -0.5,
                        dtype=torch.float32)
                s = torch.rand(co, generator=gen, device="cuda") + 0.5
                t = rnd(co, scale=0.1, dtype=torch.float32)
                new = lambda: conv_stack.conv3x3x3(x1, w, s, t)  # noqa
                plain = lambda: conv_stack.conv3x3x3_plain(  # noqa
                    x1, w, s, t)
                flops = 2.0 * 27 * ci * co * B * e ** 3
                moved = (nbytes(x1) / c1) * (ci + co) + w.numel() * 2
            elif kind == "raw":
                w = rnd(co, ci, 3, 3, 3, scale=(27 * ci) ** -0.5,
                        dtype=torch.float32)
                new = lambda: conv3d.conv3d(x1, w)  # noqa
                plain = lambda: conv3d.conv3d_plain(x1, w)  # noqa
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
                   f" {mode}{' (c1 kernel)' if ci == 1 else ''}")
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
            # the c1 launches (~0.1 ms) and their cuDNN calls back to back:
            # a single call's time would hold the wrapper's host time
            n = C1_REPEAT if ci == 1 else 1

            def per_call(f):
                return cuda_ms(lambda: [f() for _ in range(n)], reps=5) / n
            ms = per_call(new)
            xl = (x1 if x2 is None else torch.cat([x1, x2], -1)).permute(
                0, 4, 1, 2, 3)
            if kind in ("fwd", "eval", "raw"):
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
            lib_ms = per_call(lib)
            # the entry conv's plain version too (PERF.md's table)
            plain_ms = per_call(plain) if ci == 1 else None
            bound_ms, bound_by = bound(moved, flops, BF16_FLOPS)
            recs = {"kind": kind, "name": name, "edge": e, "parts": [c1, c2],
                    "out": co, "mode": mode,
                    "ms": ms, "tflops": flops / ms / 1e9,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "share_of_bound": bound_ms / ms, "cudnn_ms": lib_ms,
                    "plain_ms": plain_ms, "back_to_back": n}
            print(f"# sweep {tag}: ms {ms:.4f} ({flops / ms / 1e9:.1f} "
                  f"TFLOP/s, {100 * bound_ms / ms:.1f}% of the bound "
                  f"{bound_ms:.4f} ms, {bound_by}); cuDNN {lib_ms:.4f} ms"
                  f"{' (no prologue)' if pro is not None else ''}"
                  f"{f'; plain {plain_ms:.4f} ms' if plain_ms else ''}"
                  f"{f'; per call over {n} back to back' if n > 1 else ''}",
                  flush=True)
            if ci == 1 and not ms < lib_ms:
                fail(f"sweep {tag}: the c1 kernel ({ms:.4f} ms) is not "
                     f"faster than cuDNN ({lib_ms:.4f} ms)")
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
    of the named __global__ functions of the build, an instantiation of a
    template with its arguments (<1, 4, 1>)."""
    entry = None
    for line in open(_build.ptxas_log_path()).read().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = next((k for k in kernels if k in m.group(1)), None)
            t = re.search(r"I((?:L[ib]\d+E)+)E", m.group(1))
            if entry and t:
                entry += "<" + ", ".join(
                    re.findall(r"L[ib](\d+)E", t.group(1))) + ">"
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
            "maxpool2_bwd_first": (pool, "maxpool2_bwd_first"),
            "stencil_attention_generic": (window_attention,
                                          "stencil_attention_generic"),
            "stencil_attention_scal_generic": (
                window_attention, "stencil_attention_scal_generic"),
            "stencil_attention_bwd_generic": (
                window_attention, "stencil_attention_bwd_generic"),
            "conv3x3x3_c1": (conv_stack, "conv3x3x3_c1"),
            "conv3x3x3_c1_dw": (conv_stack, "conv3x3x3_c1_dw")}
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
    # rows 2, 6 and 7 on every other stencil and width
    "stencil_attention_generic": (
        "dram_tpu_torch/kernels/csrc/stencil_attention_generic.cu",
        "dram_tpu/core/pallas/window_attention.py:262"),
    "stencil_attention_scal_generic": (
        "dram_tpu_torch/kernels/csrc/stencil_attention_generic.cu",
        "dram_tpu/core/pallas/window_attention.py:335"),
    "stencil_attention_bwd_generic": (
        "dram_tpu_torch/kernels/csrc/stencil_attention_generic_bwd.cu",
        "dram_tpu/core/pallas/window_attention.py:366"),
    # the network-entry conv (Ci = 1) of rows 1 / 10 and 5 / 11
    "conv3x3x3_c1": ("dram_tpu_torch/kernels/csrc/conv3x3x3_c1.cu",
                     "dram_tpu/core/pallas/fused_stack.py:305"),
    "conv3x3x3_c1_dw": ("dram_tpu_torch/kernels/csrc/conv3x3x3_c1.cu",
                        "dram_tpu/core/pallas/fused_stack.py:388"),
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
           "maxpool2_bwd_first": "maxpool2_bwd_kernel",
           "stencil_attention_generic": "stencil_attention_generic_kernel",
           "stencil_attention_scal_generic":
               "stencil_attention_scal_generic_kernel",
           "stencil_attention_bwd_generic":
               "stencil_attention_bwd_plus_kernel, "
               "stencil_attention_bwd_minus_kernel",
           "conv3x3x3_c1": "conv3x3x3_c1_kernel, colsum_kernel",
           "conv3x3x3_c1_dw": "conv3x3x3_c1_dw_kernel, colsum_kernel"}
for _k in ("conv3x3x3_train", "conv3x3x3_dx", "conv3d", "conv3d_dx"):
    GLOBALS[_k] = GLOBALS["conv3x3x3"]
GLOBALS["conv3d_dw"] = GLOBALS["conv3x3x3_dw"]
# the kernels each path launches: the chunk-wire inference, the
# st_dram_ref training step and the flagship st_dram_ref_att training step,
# each with the fused conv stack; the flagship's inference and training
# step with the unfused one. Every DC3D forward runs its entry conv on
# conv3x3x3_c1, every DC3D backward that conv's dW on conv3x3x3_c1_dw.
TRAIN_KERNELS = ("conv3x3x3_train", "conv3x3x3_dx", "conv3x3x3_dw",
                 "conv3x3x3_c1", "conv3x3x3_c1_dw", "maxpool2",
                 "maxpool2_bwd", "upsample2x", "upsample2x_bwd")
ATTENTION_TRAIN = ("stencil_attention", "stencil_attention_scal",
                   "stencil_attention_bwd")
PATHS = {"pipeline": ("conv3x3x3", "conv3x3x3_c1", "maxpool2",
                      "upsample2x", "stencil_attention"),
         "train": TRAIN_KERNELS,
         "train_att": TRAIN_KERNELS + ATTENTION_TRAIN,
         "pipeline_unfused": ("conv3d", "conv3x3x3_c1", "maxpool2",
                              "upsample2x", "stencil_attention"),
         "engine": ("conv3x3x3", "conv3x3x3_c1", "maxpool2", "upsample2x",
                    "stencil_attention"),
         "train_unfused": ("conv3d", "conv3d_dx", "conv3d_dw",
                           "conv3x3x3_c1", "conv3x3x3_c1_dw", "maxpool2",
                           "maxpool2_bwd_first", "upsample2x",
                           "upsample2x_bwd") + ATTENTION_TRAIN}
# the training golden's step (golden.train_golden_batch, 2 x 48^3) with
# the fused and the unfused stack
PATHS["train_golden"] = PATHS["train_att"]
PATHS["train_golden_unfused"] = PATHS["train_unfused"]
# the scan wires (process_prepped on p12 and w8, process from the raw
# scan) and the engine on the w8 wire run the chunk wire's forward
for _p in ("pipeline_p12", "pipeline_w8", "pipeline_device", "engine_w8"):
    PATHS[_p] = PATHS["pipeline"]
# the epoch loop: the flagship's training steps and, in validation, the
# chunk wire's forward
PATHS["train_epochs"] = tuple(dict.fromkeys(PATHS["train_att"]
                                            + PATHS["pipeline"]))
# the variants: A, the PCM on the generic attention kernels (its scan
# and its step; the second PCM with the positional encoding runs the
# plain PCM path, so its step launches the backbone's kernels only); B,
# the unfused stack with 'in' norms, PReLU and dropout, AdamW with
# groups and IntRegAffRefineLoss (its step, and the CLI's epoch with
# validation and resume)
GENERIC_TRAIN = ("stencil_attention_generic", "stencil_attention_scal_generic",
                 "stencil_attention_bwd_generic")
UNFUSED_TRAIN = ("conv3d", "conv3d_dx", "conv3d_dw", "conv3x3x3_c1",
                 "conv3x3x3_c1_dw", "maxpool2", "maxpool2_bwd_first",
                 "upsample2x", "upsample2x_bwd")
PATHS["pipeline_generic"] = ("conv3x3x3", "conv3x3x3_c1", "maxpool2",
                             "upsample2x", "stencil_attention_generic")
PATHS["train_generic"] = TRAIN_KERNELS + GENERIC_TRAIN
PATHS["train_geo"] = TRAIN_KERNELS
PATHS["train_variant_b"] = UNFUSED_TRAIN + ATTENTION_TRAIN
PATHS["variant_b_epochs"] = PATHS["train_variant_b"]
PATHS["variant_b_resume"] = PATHS["train_variant_b"]
# multi-device: each rank of train dp / train dp pad runs the flagship's
# step; the scan-sharded engine the chunk wire's forward; overlap tiles
# the backbone's forward (a local upsample: no upsample kernel); the
# sharded PCM its plain path (z0 != 0, as dram_tpu dispatches)
PATHS["train_dp"] = PATHS["train_att"]
PATHS["engine_shard"] = PATHS["engine"]
PATHS["overlap_tile"] = ("conv3x3x3", "conv3x3x3_c1", "maxpool2")
PATHS["pcm_sharded"] = ()
FORWARD_LAUNCHES = {"conv3x3x3": 13, "conv3x3x3_c1": 1, "maxpool2": 3,
                    "upsample2x": 3, "stencil_attention": 1}


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
    return report_scan(pipe.process_chunks(prepc, want_heatmap=want_heatmap),
                       label)


def report_scan(out, label):
    """Print a scan's stage times and mask sizes; fail unless its masks
    have the scan's shape and its ratios and threshold are finite."""
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


def run_train(settings, label, batch, bench, backbone_only=False,
              steps=TRAIN_STEPS):
    """`steps` steps of `settings` from the flagship's weights (all of
    them, its backbone only with `backbone_only`, none when `bench` is
    None: INITIALIZER) on `batch`; returns the step-1 loss terms,
    gradients and buffers."""
    first = {}

    def on_step(i, step, r):
        if i == 0:
            first["grads"] = {n: p.grad.detach().float().clone()
                              for n, p in step.model.named_parameters()}
            first["buffers"] = {n: b.detach().clone()
                                for n, b in step.model.named_buffers()}

    out = train_steps(settings, steps, [batch], device="cuda",
                      weights_path=bench, on_step=on_step,
                      backbone_only=backbone_only)
    for i in range(steps):
        terms, ms = out["losses"][i], out["ms"][i]
        names = ("reg", "seg") if len(terms) == 2 else \
            tuple(f"loss {k}" for k in range(len(terms)))
        print(f"# train {label} step {i + 1}: "
              + " ".join(f"{n} {x:.6g}" for n, x in zip(names, terms))
              + f" total {out['loss'][i]:.6g}; ms forward "
              f"{ms['forward']:.1f} backward {ms['backward']:.1f} optimizer "
              f"{ms['optimizer']:.1f}; peak {out['peak_mib'][i]:.0f} MiB",
              flush=True)
        if not np.isfinite(out["losses"][i] + [out["loss"][i]]).all():
            fail(f"train {label} step {i + 1}: non-finite loss")
    for n, g in first["grads"].items():
        if not torch.isfinite(g).all():
            fail(f"train {label}: non-finite gradient of {n}")
    first["losses"] = out["losses"][0]
    first["peak_mib"] = max(out["peak_mib"])
    return first


def zero_in_exact_arithmetic(name):
    """The tap heads' 1x1x1 conv biases: a train-mode BatchNorm follows
    and subtracts the batch mean; the PCM's geo_phi bias (the positional
    merge types): it adds geo_theta_i . b to every logit of row i, which
    the softmax cancels. Their gradients are zero in exact arithmetic and
    hold only rounding."""
    return (name.startswith("reshape_") and name.endswith("conv.bias")) \
        or name == "attention_module.geo_phi.bias"


def check_head_grads(run, label, n_heads=16):
    """Every PCM and tap-head parameter (n_heads of them) gets a non-zero,
    finite gradient (the conv biases of zero_in_exact_arithmetic a finite
    one): no gradient is dropped on the way to them."""
    heads = {n: g for n, g in run["grads"].items()
             if n.startswith(("attention_module.", "reshape_"))}
    if len(heads) != n_heads:
        fail(f"train {label}: expected {n_heads} PCM and tap-head "
             f"parameters, got {sorted(heads)}")
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
    ones (r1 = 0.9 r0 + 0.1 batch); at TRAIN_LIMITS[label] where the
    configuration has its own."""
    lim = TRAIN_LIMITS.get(label, {})
    slope_lim = lim.get("slope_rel", SLOPE_REL)
    rl2_lim = lim.get("grad_rel_l2", GRAD_REL_L2)
    rel = [abs(a - b) / max(abs(b), 1e-30)
           for a, b in zip(k["losses"], p["losses"])]
    cos, rl2 = {}, {}
    # the PReLU slopes (one scalar a stack): each on its own at SLOPE_REL,
    # and together as one vector under the cosine and GRAD_REL_L2
    pairs = [(n, k["grads"][n], gp) for n, gp in p["grads"].items()
             if not zero_in_exact_arithmetic(n)]
    slopes = [(n, gk, gp) for n, gk, gp in pairs
              if n.endswith("negative_slope")]
    slope_rel = {}
    if slopes:
        for n, gk, gp in slopes:
            slope_rel[n] = abs(gk.item() - gp.item()) / max(abs(gp.item()),
                                                             1e-30)
            print(f"# {label} {n}: gradient {gk.item():.6g} (plain "
                  f"{gp.item():.6g}), relative error {slope_rel[n]:.3g} "
                  f"(allowed {slope_lim})", flush=True)
        pairs = [t for t in pairs if not t[0].endswith("negative_slope")] \
            + [(f"PReLU slopes ({len(slopes)})",
                torch.stack([gk.flatten() for _, gk, _ in slopes]),
                torch.stack([gp.flatten() for _, _, gp in slopes]))]
    for n, gk, gp in pairs:
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
          f"L2 {rl2[wr]:.3g} ({wr}, allowed {rl2_lim}); BatchNorm batch "
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
            and rl2[wr] <= rl2_lim and bn[wb] <= BN_REL_L2
            and all(e <= slope_lim for e in slope_rel.values())):
        fail(f"{label} step with the kernels disagrees with the plain run")


def train_phases(settings, name, bench, initial_of, launches, extra=None,
                 expect=None, backbone_only=False, steps=TRAIN_STEPS):
    """Phases `name` and `name plain`: `steps` steps of `settings` with
    the kernels (launch counts of PATHS[name] zeroed just before, read
    just after), the same steps with the plain versions, and the gate
    between them (the same start and the same generator seeds for
    dropout and the loss's transforms). `extra(batch)` runs first in the
    kernel phase; `initial_of()` gives the start's buffers; `expect` the
    launches per step; `bench` and `backbone_only` as in run_train.
    Returns both runs."""
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
        k_run = run_train(settings, tag + "kernels", batch, bench,
                          backbone_only, steps)
        launches[name] = path_counts(name, {
            k: n * steps for k, n in (expect or {}).items()})
        print(f"# launches over the {steps} {tag}training steps: "
              f"{launches[name]}", flush=True)
        torch.cuda.empty_cache()

    with phase(f"{label} plain", LIMITS[name + "_plain"]):
        print("# plain versions: f32 math, TF32 off "
              "(cudnn.allow_tf32 = cuda.matmul.allow_tf32 = False)",
              flush=True)
        with plain_versions():
            p_run = run_train(settings, tag + "plain versions", batch, bench,
                              backbone_only, steps)
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


def compare_lossy(a, b, label):
    """The w8 wire's gate (tests/test_fast_infer.py): pred Dice > 0.98
    and every ratio within 5e-3; prints the post mask's Dice beside it."""
    d_pred, d_post = dice(a["pred"], b["pred"]), dice(a["post"], b["post"])
    d_ratio = np.abs(np.asarray(a["ratios"]) - np.asarray(b["ratios"])).max()
    print(f"# {label}: dice pred {d_pred:.6f} post {d_post:.6f}, otsu "
          f"{a['threshold']:.6f} vs {b['threshold']:.6f}, ratios max diff "
          f"{d_ratio:.3g}", flush=True)
    if not (d_pred > 0.98 and d_ratio <= 5e-3):
        fail(f"{label}: beyond the w8 wire's gate")


def host_cpu():
    """This host's CPU: lscpu's model name, vendor, family and model (the
    name reads "unknown" on hosts that mask it)."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True,
                         timeout=20).stdout.splitlines()
    fields = dict(ln.strip().split(":", 1) for ln in out if ":" in ln)
    fields = {k.strip(): v.strip() for k, v in fields.items()}
    return (f"{fields.get('Model name', 'unknown CPU')} "
            f"({fields.get('Vendor ID', '?')} family "
            f"{fields.get('CPU family', '?')} model "
            f"{fields.get('Model', '?')})")


def timed(fn, reps):
    """(fn()'s last result, median wall ms over `reps` calls)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.median(times))


def bits_dice(a, b, n):
    return dice(np.unpackbits(a)[:n], np.unpackbits(b)[:n])


def compare_preps(nat, ref, label):
    """The C++ chunk prep against the NumPy one of the same scan: the same
    geometry, the chunks within BLOCK_MEAN_ATOL in every 8^3 block mean,
    candidate and lobe bits at Dice >= 0.999 (the two resamples round
    some voxels to another HU)."""
    for k in ("iso_shape", "bucket", "crop_lo", "starts", "present"):
        if not np.array_equal(nat[k], ref[k]):
            fail(f"host prep {label}: {k} {nat[k]} vs {ref[k]}")
    dmean = np.abs(block_means(nat["x80_bits"])
                   - block_means(ref["x80_bits"])).max()
    n_iso = int(np.prod(nat["iso_shape"]))
    n_lobe = len(nat["present"]) * int(np.prod(nat["bucket"]))
    d_cand = bits_dice(nat["cand_bits"], ref["cand_bits"], n_iso)
    d_lobe = bits_dice(nat["lobe_bits"], ref["lobe_bits"], n_lobe)
    same = int((nat["x80_bits"] == ref["x80_bits"]).sum())
    print(f"# host prep {label}: native vs NumPy chunks: 8^3 block means "
          f"within {dmean:.3g} (allowed {BLOCK_MEAN_ATOL:.3g}), "
          f"{same} of {nat['x80_bits'].size} chunk values bit-identical; "
          f"candidate bits dice {d_cand:.6f}, lobe bits dice {d_lobe:.6f}; "
          f"intensity threshold {nat['intensity_threshold']:.6f} vs "
          f"{ref['intensity_threshold']:.6f}", flush=True)
    if not (dmean <= BLOCK_MEAN_ATOL and d_cand >= 0.999
            and d_lobe >= 0.999):
        fail(f"host prep {label}: the native and NumPy preps disagree")


def hostprep_digest():
    """SHA-256 of the C++ prep of a seeded DIGEST_SHAPE scan: chunk,
    lobe and candidate bits of the chunk wire and the p12 and w8 scan
    wires."""
    scan, lobe, _, vessel, _ = synth_scan(np.random.default_rng(SEED),
                                          DIGEST_SHAPE,
                                          lesion_severity=SEVERITIES)
    c = prep_scan_chunks(scan, lobe, SPACING, vessel_u8=vessel,
                         windowing_span=WINDOW)
    p = prep_scan(scan, lobe, SPACING, vessel_u8=vessel)
    w = prep_scan(scan, lobe, SPACING, vessel_u8=vessel,
                  windowing_span=WINDOW)
    return sha256(c["x80_bits"], c["lobe_bits"], c["cand_bits"],
                  p["packed_scan"], p["packed_lobe"], w["packed_scan"])


def load_host_prep():
    """Build (if need be) and load the C++ host prep: (built now, s)."""
    t0 = time.perf_counter()
    cold = not os.path.exists(native.library_path())
    native.load()
    return cold, time.perf_counter() - t0


def host_prep_phase(draw, prepc_np, np_ms, host_build):
    """Report the C++ host prep's build (`host_build`, load_host_prep's
    result); time it against the NumPy prep on the
    pipeline scan and on a BENCH_SHAPE scan; hold its chunk wire against
    the NumPy one's on both (compare_preps); print its digest beside
    DIGEST_SHA256. Returns the C++ preps of the pipeline scan: (chunk
    wire, p12, w8)."""
    cold, build_s = host_build
    version, simd = native.build_report()
    cpu = host_cpu()
    print(f"# host prep build: {os.path.basename(native.library_path())} "
          f"({'built' if cold else 'found built'}, {build_s:.1f} s); "
          f"{version}; {cpu}, {os.cpu_count()} cores; AVX-512 paths "
          "compiled in: " + ", ".join(
              f"{k.strip('_')} {'yes' if v else 'no'}"
              for k, v in simd.items()), flush=True)
    scan, lobe, vessel = draw
    kw = dict(vessel_u8=vessel)
    prepc, ms_c = timed(lambda: prep_scan_chunks(
        scan, lobe, SPACING, windowing_span=WINDOW, **kw), 3)
    p12, ms_p = timed(lambda: prep_scan(scan, lobe, SPACING, **kw), 3)
    w8, ms_w = timed(lambda: prep_scan(scan, lobe, SPACING,
                                       windowing_span=WINDOW, **kw), 3)
    _, ms_pn = timed(lambda: prep_scan(scan, lobe, SPACING, prep="numpy",
                                       **kw), 1)
    print(f"# host prep {SCAN_SHAPE} at {SPACING} mm: chunk wire native "
          f"{ms_c:.1f} ms (median of 3) vs NumPy {np_ms:.1f} ms; p12 native "
          f"{ms_p:.1f} ms vs NumPy {ms_pn:.1f} ms; w8 native {ms_w:.1f} ms "
          f"({cpu})", flush=True)
    compare_preps(prepc, prepc_np, str(SCAN_SHAPE))

    big = synth_scan(np.random.default_rng(SEED), BENCH_SHAPE,
                     lesion_severity=SEVERITIES)
    args = (big[0], big[1], BENCH_SPACING)
    kw = dict(vessel_u8=big[3], windowing_span=WINDOW)
    big_nat, ms_bn = timed(lambda: prep_scan_chunks(*args, **kw), 3)
    big_np, ms_bp = timed(lambda: prep_scan_chunks(*args, **kw,
                                                   prep="numpy"), 1)
    _, ms_bw = timed(lambda: prep_scan(*args, **kw), 3)
    print(f"# host prep {BENCH_SHAPE} at {BENCH_SPACING} mm -> iso crop "
          f"{big_nat['iso_shape']}: chunk wire native {ms_bn:.1f} ms "
          f"(median of 3) vs NumPy {ms_bp:.1f} ms; w8 native {ms_bw:.1f} "
          f"ms ({cpu})", flush=True)
    compare_preps(big_nat, big_np, str(BENCH_SHAPE))
    del big, big_nat, big_np

    digest = hostprep_digest()
    same = "equal" if digest == DIGEST_SHA256 else "DIFFERENT"
    print(f"# host prep digest of a seeded {DIGEST_SHAPE} scan: this host "
          f"{digest}, recorded {DIGEST_SHA256}: {same} (information, not a "
          "gate)", flush=True)
    return prepc, p12, w8


def wire_phases(pipe, draw, preps, launches):
    """The scan wires on the pipeline scan with the kernels, counts zeroed
    before each and read after: pipeline p12 (process_prepped on the
    12-bit wire) against the chunk wire of the same C++ resample (the
    lossless pair: Dice >= 0.995, the same Otsu bin); pipeline w8 against
    p12 (compare_lossy); pipeline device-resample (process from the raw
    scan, iso resample on the card) against p12 (compare_lossy, the gate
    of tests/test_fast_infer.py for process against process_prepped).
    Returns the chunk wire's heatmap run of the C++ prep."""
    scan, lobe, vessel = draw
    prepc, p12, w8 = preps
    runs = {}
    with phase("pipeline p12", LIMITS["pipeline_wire"]):
        wc = run_scan(pipe, prepc, False, "kernels, native prep")
        wc_heat = run_scan(pipe, prepc, True, "kernels, native prep, heatmap")
        zero_counts()
        report_scan(pipe.process_prepped(p12), "p12, cold")
        runs["p12"] = report_scan(pipe.process_prepped(p12), "p12, warm")
        launches["pipeline_p12"] = path_counts("pipeline_p12", {
            k: 2 * n for k, n in FORWARD_LAUNCHES.items()})
        print(f"# launches over the two p12 scans: "
              f"{launches['pipeline_p12']}", flush=True)
        compare_masks(runs["p12"], wc, "p12 vs wc (lossless wires)")
    with phase("pipeline w8", LIMITS["pipeline_wire"]):
        zero_counts()
        report_scan(pipe.process_prepped(w8), "w8, cold")
        runs["w8"] = report_scan(pipe.process_prepped(w8), "w8, warm")
        launches["pipeline_w8"] = path_counts("pipeline_w8", {
            k: 2 * n for k, n in FORWARD_LAUNCHES.items()})
        print(f"# launches over the two w8 scans: {launches['pipeline_w8']}",
              flush=True)
        compare_lossy(runs["w8"], runs["p12"], "w8 vs p12")
    with phase("pipeline device-resample", LIMITS["pipeline_wire"]):
        iso_vessel = native.hostprep_native.resample_iso_labels(
            vessel, SPACING, 1.0)
        zero_counts()
        report_scan(pipe.process(scan, lobe, SPACING, vessel_np=iso_vessel),
                    "device resample, cold")
        runs["device"] = report_scan(
            pipe.process(scan, lobe, SPACING, vessel_np=iso_vessel),
            "device resample, warm")
        launches["pipeline_device"] = path_counts("pipeline_device", {
            k: 2 * n for k, n in FORWARD_LAUNCHES.items()})
        print(f"# launches over the two device-resample scans: "
              f"{launches['pipeline_device']}", flush=True)
        compare_lossy(runs["device"], runs["p12"], "device resample vs p12")
    return wc_heat


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

# --- the inference engine (dram_tpu_torch.infer.engine.LesionSegTest) -------

# the engine phase's RadboudCOVID split: three synthetic scans of
# SCAN_SHAPE at SPACING (seeds SEED + 1..3) and a fourth whose image file
# is cut in half
ENGINE_GOOD = ("p000_s1", "p001_s1", "p002_s1")
ENGINE_TRUNCATED = "p003_s1"
LOBE_COLUMNS = ("lul [0-5]", "lll [0-5]", "rul [0-5]", "rll [0-5]",
                "rml [0-5]")
# the forward kernels of a lobe's batch-1 forward on the host-stitch
# path, each against its plain version at the kernel phases' tolerances
FORWARD_TOL = {"conv3x3x3": bf16_tol(2 ** -7),
               "conv3x3x3_c1": bf16_tol(2 ** -7), "maxpool2": lambda yp: 0.0,
               "upsample2x": bf16_tol(2 ** -7),
               "stencil_attention": lambda yp: 1e-4 * yp.abs().max().item()}


def engine_settings(root, **values):
    """The flagship's settings (configs/st_dram_ref_att) with the paths
    under `root` and logging to stderr."""
    return with_settings(st_dram_ref_att, DB_PATH=f"{root}/db",
                         TEST_CSV=f"{root}/db/wss_all.csv",
                         MODEL_ROOT_PATH=f"{root}/models/",
                         DEBUG_PATH=f"{root}/debug/", LOGGING={}, **values)


def write_engine_split(db):
    """The RadboudCOVID layout of the engine phase under `db`."""
    rows = []
    for i, uid in enumerate(ENGINE_GOOD + (ENGINE_TRUNCATED,)):
        scan, lobe, lesion, vessel, sev = synth_scan(
            np.random.default_rng(SEED + 1 + i), SCAN_SHAPE)
        for folder, arr in (("images", scan), ("lobes", lobe),
                            ("lesion", lesion), ("pseudo_vessels", vessel)):
            write_mha(f"{db}/wss/{folder}/{uid}.mha", arr, spacing=SPACING)
        pid, sid = uid.split("_")
        rows.append({"patientid": pid, "study": sid,
                     **dict(zip(LOBE_COLUMNS, sev))})
    path = f"{db}/wss/images/{ENGINE_TRUNCATED}.mha"
    with open(path, "rb") as fp:
        data = fp.read()
    with open(path, "wb") as fp:
        fp.write(data[:len(data) // 2])
    with open(f"{db}/wss_all.csv", "wt", newline="") as fp:
        w = csv.DictWriter(fp, fieldnames=["patientid", "study",
                                           *LOBE_COLUMNS])
        w.writeheader()
        w.writerows(rows)


@contextlib.contextmanager
def error_log(settings):
    """The engine's ERROR records while the block runs."""
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())
    handler = Keep(logging.ERROR)
    logger = logging.getLogger(settings.EXP_NAME)
    logger.addHandler(handler)
    try:
        yield records
    finally:
        logger.removeHandler(handler)


def print_scan_times(eng, label, card):
    for t in eng.timings:
        stages = " / ".join(f"{k} {t[k]:.1f}" for k in
                            ("pre", "model", "post") if k in t)
        print(f"# engine {label} scan {t['uid']}: load {t['load']:.1f} ms, "
              f"prep {t['prep']:.1f} ms, {stages} ms, archive "
              f"{t['archive']:.1f} ms (screenshots {t['screenshots']:.1f}), "
              f"total {t['total']:.1f} ms ({card})", flush=True)


def engine_phase(root, params, batch_stats, card):
    """LesionSegTest on the flagship over the engine split, fast path:
    every good scan archived at its shape with a finite Dice, the
    truncated one logged and missing, rows 1-4 launched (counts zeroed
    just before the run, read just after); then a restart over the same
    output, which archives nothing and launches nothing. Returns the
    engine path's launch counts and the checkpoint's path."""
    write_engine_split(f"{root}/db")
    settings = engine_settings(root)
    ckpt = f"{root}/models/{settings.EXP_NAME}/1.ckpt"
    save_checkpoint(ckpt, {"model": {"params": params,
                                     "batch_stats": batch_stats},
                           "epoch": 1, "iteration": 0})
    out = f"{root}/engine"
    eng = LesionSegTest(settings, output_path=out, device="cuda")
    zero_counts()
    with error_log(settings) as errors:
        rows = eng.run()
    torch.cuda.synchronize()
    n = len(ENGINE_GOOD)
    counts = path_counts("engine", {k: n * c for k, c in
                                    FORWARD_LAUNCHES.items()})
    print(f"# engine launches over {n} scans: {counts}", flush=True)
    print_scan_times(eng, "fast", card)
    for row in rows:
        print(f"# engine {row['uid']}: dice {row['dice']:.6f} dice_post "
              f"{row['dice_post']:.6f} iou {row['iou']:.6f} acc "
              f"{row['acc']:.3f}", flush=True)
    if [r["uid"] for r in rows] != list(ENGINE_GOOD) or \
            not all(np.isfinite(r[k]) for r in rows
                    for k in ("dice", "dice_post", "iou", "iou_post")):
        fail(f"engine: records {rows}")
    task = f"{out}/test"
    for uid in ENGINE_GOOD:
        for sub in ("", "post/", "heatmap/"):
            a = read_mha(f"{task}/{sub}{uid}.mha")["array"]
            if a.shape != SCAN_SHAPE:
                fail(f"engine: {sub}{uid}.mha has shape {a.shape}")
    if os.path.exists(f"{task}/{ENGINE_TRUNCATED}.mha") or not any(
            f"({ENGINE_TRUNCATED})" in e for e in errors):
        fail(f"engine: the truncated scan {ENGINE_TRUNCATED} was not "
             f"logged as failed ({errors})")
    shots = [f for f in os.listdir(f"{task}/screenshots")
             if f.endswith(".jpg")]
    print(f"# engine: {len(rows)} scans archived; {ENGINE_TRUNCATED} "
          f"failed alone ({errors[0].splitlines()[-1]}); screenshots of "
          f"{len(shots)} scans (none without cv2)", flush=True)

    again = LesionSegTest(engine_settings(root), output_path=out,
                          device="cuda")
    zero_counts()
    again.run()
    torch.cuda.synchronize()
    stray = {k: getattr(*WRAPPERS[k]).launches for k in WRAPPERS
             if getattr(*WRAPPERS[k]).launches}
    if again.timings or again.test_set.uids != [ENGINE_TRUNCATED] or stray:
        fail(f"engine restart: archived {len(again.timings)} scans, tried "
             f"{again.test_set.uids}, launched {stray}")
    print(f"# engine restart: 0 scans archived, {ENGINE_TRUNCATED} tried "
          "again and failed again, no launch", flush=True)
    return counts, ckpt


def engine_w8_phase(root, card):
    """LesionSegTest with FAST_WIRE = "w8" over the engine split: every
    good scan archived, the truncated one logged and missing, rows 1-4
    launched once a scan (counts zeroed just before, read just after,
    path engine_w8); each archived pred mask against the engine phase's
    chunk-wire one at the w8 wire's Dice > 0.98. Returns the launch
    counts."""
    settings = engine_settings(root, FAST_WIRE="w8")
    out = f"{root}/engine_w8"
    eng = LesionSegTest(settings, output_path=out, device="cuda")
    zero_counts()
    with error_log(settings) as errors:
        rows = eng.run()
    torch.cuda.synchronize()
    n = len(ENGINE_GOOD)
    counts = path_counts("engine_w8", {k: n * c for k, c in
                                       FORWARD_LAUNCHES.items()})
    print(f"# engine w8 launches over {n} scans: {counts}", flush=True)
    print_scan_times(eng, "w8", card)
    if [r["uid"] for r in rows] != list(ENGINE_GOOD) or not all(
            np.isfinite(r["dice"]) for r in rows) or not any(
            f"({ENGINE_TRUNCATED})" in e for e in errors):
        fail(f"engine w8: records {rows}, errors {errors}")
    for uid in ENGINE_GOOD:
        got = {k: read_mha(f"{out}/test/{sub}{uid}.mha")["array"]
               for k, sub in (("pred", ""), ("post", "post/"))}
        wc = {k: read_mha(f"{root}/engine/test/{sub}{uid}.mha")["array"]
              for k, sub in (("pred", ""), ("post", "post/"))}
        d = {k: dice(got[k], wc[k]) for k in got}
        print(f"# engine w8 {uid} vs the wc wire: dice pred {d['pred']:.6f} "
              f"post {d['post']:.6f}", flush=True)
        if got["pred"].shape != SCAN_SHAPE or not d["pred"] > 0.98:
            fail(f"engine w8: {uid}'s pred mask beyond the w8 wire's gate")
    return counts


def write_deploy_dirs(root, scan, lobe, uid="scan0"):
    """The weights phase's scan and lobes as a deployment directory."""
    write_mha(f"{root}/ct/{uid}.mha", scan, spacing=SPACING)
    write_mha(f"{root}/lobes/{uid}.mha", lobe, spacing=SPACING)
    return f"{root}/ct", f"{root}/lobes", uid


def engine_deploy_phase(root, ckpt, deploy, pipe, heat_run, card):
    """The CLI (python3 -m dram_tpu_torch.process_pipeline) in deployment
    mode on the weights phase's scan: its archived pred mask and heatmap
    equal, bitwise, the heatmap run of the same scan on the C++ prep in
    the pipeline p12 phase (`heat_run`), and its post mask that of the
    same scan prepped without the vessel mask (TestDataset has none)."""
    ct, lobes, uid = deploy
    out = f"{root}/deploy"
    env = dict(os.environ, DRAM_OUTPUT_ROOT=f"{root}/cli")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "dram_tpu_torch.process_pipeline",
         "--input", ct, "--lobes", lobes, "--output", out,
         "--ckp_path", ckpt, "--device", "cuda"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=LIMITS["engine_deploy"] - 30)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"engine deploy: the CLI exited {r.returncode}: "
             f"{r.stderr[-2000:]}")
    print(f"# engine deploy: the CLI took {wall:.1f} s ({card})",
          flush=True)
    got = {k: read_mha(f"{out}/test/{sub}{uid}.mha")["array"]
           for k, sub in (("pred", ""), ("post", "post/"),
                          ("heatmap", "heatmap/"))}
    with open(f"{out}/test/records.csv") as fp:
        if fp.read().split() != ["uid", uid]:
            fail("engine deploy: records.csv")
    prep = prep_scan_chunks(read_mha(f"{ct}/{uid}.mha")["array"],
                            read_mha(f"{lobes}/{uid}.mha")["array"],
                            SPACING, windowing_span=WINDOW)
    novessel = run_scan(pipe, prep, True, "kernels, no vessel mask")
    checks = {"pred vs the pipeline p12 phase": (got["pred"],
                                                 heat_run["pred"]),
              "heatmap vs the pipeline p12 phase": (got["heatmap"],
                                                    heat_run["heatmap_u8"]),
              "pred without vessels": (got["pred"], novessel["pred"]),
              "heatmap without vessels": (got["heatmap"],
                                          novessel["heatmap_u8"]),
              "post without vessels": (got["post"], novessel["post"])}
    for label, (a, b) in checks.items():
        same = a.shape == b.shape and np.array_equal(a, b.astype(a.dtype))
        print(f"# engine deploy: {label}: "
              f"{'bitwise equal' if same else 'DIFFERENT'}", flush=True)
        if not same:
            fail(f"engine deploy: {label} differs")


@contextlib.contextmanager
def recorded_forward(names):
    """Record the arguments of the kernel launches of `names` up to and
    including the first stencil attention (one batch-1 forward of the
    host-stitch path); the kernels run as usual. Yields the list of
    (name, args, kwargs)."""
    calls, saved = [], {k: getattr(*WRAPPERS[k]) for k in names}

    def recorder(k):
        def rec(*args, **kw):
            if not any(c[0] == "stencil_attention" for c in calls):
                calls.append((k, [a.clone() if torch.is_tensor(a) else a
                                  for a in args],
                              {n: v.clone() if torch.is_tensor(v) else v
                               for n, v in kw.items()}))
            return saved[k](*args, **kw)
        rec.launches = 0  # the kernel's counter, looked up by its name
        return rec
    for k in names:
        setattr(*WRAPPERS[k], recorder(k))
    try:
        yield calls
    finally:
        for k in names:
            setattr(*WRAPPERS[k], saved[k])


def engine_stitch_phase(root, ckpt, deploy, card):
    """USE_FAST_INFERENCE = False on the deployment scan: the host-stitch
    path runs each lobe alone, batch 1; its masks with the kernels and
    with the plain versions agree (Dice >= 0.995, the same Otsu bin of
    the stitched heatmap); each forward kernel launch of the first
    lobe's forward is held against its plain version."""
    ct, lobes, uid = deploy
    names = PATHS["engine"]
    runs = {}
    for label in ("kernels", "plain versions"):
        settings = engine_settings(root, USE_FAST_INFERENCE=False,
                                   RELOAD_CHECKPOINT_PATH=ckpt)
        eng = LesionSegTest(settings, scan_path=ct, lobe_path=lobes,
                            output_path=f"{root}/stitch {label}",
                            device="cuda")
        stitched = {}
        process_scan = eng.process_scan

        def keep(scan_data, _f=process_scan, _out=stitched):
            out = _f(scan_data)
            lung = scan_data["#lobe_reference"] > 0
            _out["threshold"] = binary_cam_np(out["heatmap"][lung])[1]
            return out
        eng.process_scan = keep
        ctx = plain_versions() if label == "plain versions" \
            else recorded_forward(names)
        with ctx as calls:
            rows = eng.run()
        torch.cuda.synchronize()
        if len(rows) != 1:
            fail(f"engine host-stitch ({label}): {len(rows)} scans archived")
        print_scan_times(eng, f"host-stitch {label}", card)
        task = f"{root}/stitch {label}/test"
        runs[label] = {k: read_mha(f"{task}/{sub}{uid}.mha")["array"]
                       for k, sub in (("pred", ""), ("post", "post/"))}
        runs[label]["threshold"] = stitched["threshold"]
        if label == "kernels":
            launches = {k: sum(c[0] == k for c in calls) for k in names}
            print(f"# engine host-stitch: first lobe's batch-1 forward "
                  f"launched {launches}", flush=True)
            if min(launches.values()) == 0 or calls[0][1][0].shape[0] != 1:
                fail(f"engine host-stitch: not one batch-1 forward on the "
                     f"kernels ({launches})")
            for k, args, kw in calls:
                mod, attr = WRAPPERS[k]
                with torch.no_grad():  # conv3x3x3_c1 returns (y, None)
                    y = _outputs(getattr(mod, attr)(*args, **kw))[0]
                    yp = _outputs(getattr(mod, attr + "_plain")(*args,
                                                                **kw))[0]
                err = (y.float() - yp.float()).abs().max().item()
                allowed = FORWARD_TOL[k](yp.float())
                if not err <= allowed:
                    fail(f"engine host-stitch: {k} at {tuple(args[0].shape)}"
                         f" disagrees with its plain version ({err:.3g} > "
                         f"{allowed:.3g})")
            print(f"# engine host-stitch: each of the {len(calls)} launches "
                  "agrees with its plain version at batch 1", flush=True)
    k, p = runs["kernels"], runs["plain versions"]
    d_pred, d_post = dice(k["pred"], p["pred"]), dice(k["post"], p["post"])
    bins = [round(r["threshold"] * 255) for r in (k, p)]
    print(f"# engine host-stitch: kernels vs plain versions: dice pred "
          f"{d_pred:.6f} post {d_post:.6f}, otsu bins {bins}, pred voxels "
          f"{int(k['pred'].sum())}", flush=True)
    if d_pred < 0.995 or d_post < 0.995 or bins[0] != bins[1] \
            or not k["pred"].any():
        fail("engine host-stitch: the kernel and plain runs disagree")



# --- the training epoch loop (python3 -m dram_tpu_torch.train) -----------

# make_synthetic_dataset's RadboudCOVID layout of EPOCH_SCANS scans of
# SCAN_SHAPE (seed SEED): three train, the last validates; their lobe
# chunks (all four scans' chunks, as the chunk dataset reads memo.csv)
EPOCH_SCANS = 4
# about this many steps an epoch at batch 10: BALANCED_LABEL_COUNT is
# ceil(EPOCH_STEPS * 10 / the labels the chunks hold)
EPOCH_STEPS = 4
# the columns of dram_tpu's records.csv (dram_tpu/train/trainer.py:1049-1062)
RECORD_COLUMNS = ["epoch", "iteration", "learning_rate", "val_time",
                  "val_acc_reg_cls", "tr_loss", "tr_data_time",
                  "tr_batch_time"]
# sha256 of epoch 0's sampled chunk uids (LobeChunkCTSSSampler of seed
# RANDOM_SEED on that dataset), computed on an Intel Xeon host with numpy
# 2.x; printed beside this host's (a finding, not a gate)
EPOCH_UIDS_SHA256 = ("385a6dfd0dc3fd8b7b6c5941f4df67e003aa157c905286fd3961eeda"
                     "9ed51316")
# the validation's two paths on a scan: |fast - host-stitch| / host-stitch
# of the predicted lesion ratio. The sound epilogue reads 1.07e-5 on the
# trained tree; without the lung mask it reads 0.382, without the sigmoid
# 36.2 (tools/val_gate_mutants.py on an H100; PERF.md). Without the
# `present` flags it reads as sound: an absent lobe's mask is empty.
VAL_RATIO_RTOL = 1e-2


def epoch_label_count(db):
    """BALANCED_LABEL_COUNT for about EPOCH_STEPS steps of batch 10."""
    with open(f"{db}/wss_chunk/memo.csv") as fp:
        labels = {row["ctss"] for row in csv.DictReader(fp)}
    return -(-EPOCH_STEPS * 10 // len(labels))


def epoch_settings(root, db, count, **values):
    """A settings file: the flagship's configs/st_dram_ref_att with the
    dataset and outputs under `root`, logging to stderr, two epochs,
    validation and a checkpoint every epoch; `values` appended."""
    path = f"{root}/epochs_settings.py"
    lines = ["from dram_tpu_torch.configs.st_dram_ref_att import *  "
             "# noqa: F401,F403",
             f"DB_PATH = {db!r}", f"VALID_CSV = {db + '/val.csv'!r}",
             f"TEST_CSV = {db + '/test.csv'!r}",
             f"DEBUG_PATH = {root + '/debug/'!r}",
             f"MODEL_ROOT_PATH = {root + '/models/'!r}", "LOGGING = {}",
             "NUM_EPOCHS = 2", "VAL_EPOCHS = 1", "STATE_EPOCHS = 1",
             "NUM_WORKERS = 4", f"BALANCED_LABEL_COUNT = {count}"]
    lines += [f"{k} = {v!r}" for k, v in values.items()]
    with open(path, "w") as fp:
        fp.write("\n".join(lines) + "\n")
    return path


def epoch_uids_digest(db, count, seed):
    """sha256 of the chunk uids epoch 0's sampler draws, in order."""
    memo = f"{db}/wss_chunk/memo.csv"
    ds = RadboudCOVIDLobeVesselChunk(
        db, RadboudCOVIDLobeVesselChunk.get_series_uids(memo))
    smp = LobeChunkCTSSSampler(None, ds, 10, balance_label_count=count,
                               seed=seed)
    return hashlib.sha256("\n".join(ds.uids[i] for i in smp)
                          .encode()).hexdigest()


def print_epochs(runner, label, card):
    """One line per epoch of the runner's history; fails on a non-finite
    loss."""
    for e in runner.history:
        val = e.get("val_scans", [])
        vms = "; ".join(f"{v['uid']}: prep {v['prep_ms']:.1f} + "
                        f"process_chunks_val {v['val_ms']:.1f} ms"
                        for v in val if "prep_ms" in v)
        print(f"# {label} epoch {e['epoch']}: {e['steps']} steps of batch "
              f"10, losses {[round(x, 6) for x in e['losses']]}; "
              f"tr_data_time {e['tr_data_time']:.4f} s, tr_batch_time "
              f"{e['tr_batch_time']:.4f} s a step "
              f"({1.0 / e['tr_batch_time']:.3f} steps/s), epoch "
              f"{e['seconds']:.2f} s; validation {vms}; checkpoint save "
              f"{e.get('save_ms', float('nan')):.1f} ms; peak "
              f"{e['peak_mib'] or 0:.0f} MiB ({card})", flush=True)
        if not e["losses"] or not np.isfinite(e["losses"]).all():
            fail(f"{label} epoch {e['epoch']}: losses {e['losses']}")


def train_epochs_phase(root, params, batch_stats, card):
    """The CLI's main on the flagship settings (full widths, bf16, batch
    10, 80^3 chunks, four loader threads) over the synthetic dataset,
    from the trained tree: two epochs, each validated and checkpointed.
    Gates: finite losses, records.csv's two rows in dram_tpu's columns,
    0.ckpt and 1.ckpt, the scheduler stepped twice and the optimizer at
    base * gamma^2, every kernel of the train_epochs path launched and no
    other (counts zeroed just before, read just after). Returns (counts,
    runner, settings path, trained checkpoint)."""
    db = f"{root}/db"
    t0 = time.perf_counter()
    info = make_synthetic_dataset(db, n_scans=EPOCH_SCANS, size=SCAN_SHAPE,
                                  seed=SEED)
    count = epoch_label_count(db)
    print(f"# train epochs: dataset of {EPOCH_SCANS} scans {SCAN_SHAPE}, "
          f"{info['n_chunks']} lobe chunks, BALANCED_LABEL_COUNT {count}, "
          f"made in {time.perf_counter() - t0:.1f} s", flush=True)
    trained = f"{root}/trained.ckpt"
    save_checkpoint(trained, {"model": {"params": params,
                                        "batch_stats": batch_stats},
                              "epoch": 0, "iteration": 0})
    smp = epoch_settings(root, db, count)
    zero_counts()
    t0 = time.perf_counter()
    runner = train_main(["1", str(st_dram_ref_att.OPTIMIZER["lr"]),
                         "--batch_size", "10", "--smp", smp,
                         "--ckp_path", trained, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = path_counts("train_epochs")
    print(f"# train epochs launches: {counts}", flush=True)
    print(f"# train epochs: the CLI's main took {wall:.1f} s ({card})",
          flush=True)
    print_epochs(runner, "train epochs", card)
    steps = [e["steps"] for e in runner.history]
    if len(steps) != 2 or not all(3 <= n <= 6 for n in steps):
        fail(f"train epochs: steps an epoch {steps}")
    with open(runner.exp_path + "records.csv") as fp:
        rows = list(csv.DictReader(fp))
    if len(rows) != 2 or list(rows[0]) != RECORD_COLUMNS or not all(
            np.isfinite(float(r["tr_loss"])) for r in rows):
        fail(f"train epochs: records.csv {rows}")
    for f in ("0.ckpt", "1.ckpt"):
        if not os.path.exists(runner.exp_path + f):
            fail(f"train epochs: no {f}")
    sch = runner.scheduler
    lr = runner.optimizer.param_groups[0]["lr"]
    if sch.steps != 2 or abs(lr - sch.base_lr * sch.gamma ** 2) > \
            1e-12 * sch.base_lr:
        fail(f"train epochs: scheduler steps {sch.steps}, lr {lr}")
    print(f"# train epochs: records.csv rows {len(rows)}, scheduler steps "
          f"{sch.steps}, lr {lr:.6g} = {sch.base_lr:.6g} * "
          f"{sch.gamma}^2, checkpoints {sorted(os.listdir(runner.exp_path))}",
          flush=True)
    digest = epoch_uids_digest(db, count, st_dram_ref_att.RANDOM_SEED)
    print(f"# train epochs: epoch 0's sampled chunk uids sha256 {digest} "
          f"(recorded: {EPOCH_UIDS_SHA256}; "
          f"{'equal' if digest == EPOCH_UIDS_SHA256 else 'DIFFERENT'})",
          flush=True)
    return counts, runner, smp, trained


def val_path_readings(runner):
    """Validate once per path (fast, then host-stitch) with the model in
    train mode before each: per scan (uid, fast ratio, host-stitch ratio,
    fast label, host-stitch label, target). Fails when validation leaves
    the model out of train mode."""
    out = {}
    for fast in (True, False):
        runner.settings.VAL_USE_FAST_PIPELINE = fast
        runner.model.train()
        preds = []
        orig = runner.evaluate_scan

        def keep(sample, _f=orig):
            r = _f(sample)
            preds.append(r[:2])
            return r
        runner.evaluate_scan = keep
        try:
            runner.validate()
        finally:
            runner.evaluate_scan = orig
        if not runner.model.training:
            fail("train val paths: validate() left the model in eval mode")
        out[fast] = [(t["uid"], t["ratio"], p[0], p[1])
                     for t, p in zip(runner.val_timings, preds)]
    runner.settings.VAL_USE_FAST_PIPELINE = True
    return [(f[0], f[1], h[1], f[2], h[2], f[3])
            for f, h in zip(out[True], out[False])]


def train_val_paths_phase(smp, trained, card):
    """A runner of the same settings reloaded from the trained tree:
    each validation scan's fast path (the chunk wire's prep and
    process_chunks_val) and host-stitch loop (batch-1 forwards) give the
    same ordinal label and ratios within VAL_RATIO_RTOL; validation hands
    the model back in train mode."""
    s = Settings(smp)
    s.RELOAD_CHECKPOINT, s.RELOAD_CHECKPOINT_PATH = True, trained
    runner = LesionSegChunkTrain(s, device="cuda")
    for uid, fr, hr, fl, hl, target in val_path_readings(runner):
        rel = abs(fr - hr) / max(abs(hr), 1e-12)
        print(f"# train val paths {uid}: fast ratio {fr:.6f} (label {fl}), "
              f"host-stitch {hr:.6f} (label {hl}), relative difference "
              f"{rel:.3e} (limit {VAL_RATIO_RTOL}), target {target} "
              f"({card})", flush=True)
        if fl != hl or not rel <= VAL_RATIO_RTOL:
            fail(f"train val paths: {uid} disagrees between the paths")
    print("# train val paths: the model is back in train mode after each "
          "validation", flush=True)


def train_resume_phase(smp, first, card):
    """A runner with RELOAD_CHECKPOINT (newest checkpoint, model,
    optimizer and metrics): its parameters, BatchNorm buffers, Adam state
    and scheduler equal the checkpoint's and the first run's bitwise;
    then NUM_EPOCHS = 3 trains on from the checkpoint's epoch (1, as
    dram_tpu's loop restarts it) and writes 2.ckpt."""
    s = Settings(smp)
    s.RELOAD_CHECKPOINT, s.RELOAD_CHECKPOINT_PATH = True, None
    s.RELOAD_DICT_LIST = ["model", "optimizer", "metrics"]
    s.NUM_EPOCHS = 3
    again = LesionSegChunkTrain(s, device="cuda")
    path = newest_checkpoint(again.exp_path)
    saved = load_checkpoint(path)
    got = {"model": again.model_state_tree(),
           "optimizer": optimizer_state_tree(again.optimizer, again.model)}

    def leaves(tree, prefix=""):
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield prefix + k, np.asarray(v)
    n = 0
    for key in ("model", "optimizer"):
        want = dict(leaves(saved[key]))
        have = dict(leaves(got[key]))
        if want.keys() != have.keys():
            fail(f"train resume: {key} trees differ in names")
        for k, v in want.items():
            if v.dtype != have[k].dtype or not np.array_equal(v, have[k]):
                fail(f"train resume: {key} {k} differs from {path}")
            n += 1
    live = first.model.state_dict()
    for k, v in again.model.state_dict().items():
        if not torch.equal(v, live[k]):
            fail(f"train resume: {k} differs from the first run's")
    if again.scheduler.state_dict() != first.scheduler.state_dict() or \
            again.scheduler.state_dict() != saved["scheduler"]:
        fail("train resume: scheduler state")
    print(f"# train resume: {os.path.basename(path)} reloaded, {n} arrays "
          "(parameters, BatchNorm buffers, Adam count / mu / nu and "
          f"hyperparameters) and the scheduler ({again.scheduler.steps} steps) "
          "bitwise equal to the checkpoint and the first run", flush=True)
    zero_counts()
    again.run()
    torch.cuda.synchronize()
    counts = path_counts("train_epochs")
    print_epochs(again, "train resume", card)
    if not os.path.exists(again.exp_path + "2.ckpt") or \
            [e["epoch"] for e in again.history] != [1, 2]:
        fail("train resume: epochs 1..2 and 2.ckpt")
    print(f"# train resume: epochs {[e['epoch'] for e in again.history]}, "
          f"2.ckpt written, scheduler steps {again.scheduler.steps}, "
          f"launches {counts}", flush=True)
    return counts


# --- the generic stencil-attention kernels and the two variants -------------

# (stencil (k, connectivity, self loop), (F, G), batch, grid) of each check
# of the generic kernels: 64^3 but a ragged grid at halo 3; the last is
# variant A's step shape, whose times the kernels line reports. F = G = 64
# at halo 3 takes the reload ring (generic_fwd_plan), the others the whole
# ring
GENERIC_CASES = [((3, 1, True), (16, 4), 2, (64, 64, 64)),
                 ((3, 3, True), (33, 1), 2, (64, 64, 64)),
                 ((5, 2, True), (16, 4), 2, (64, 64, 64)),
                 ((7, 1, True), (8, 8), 2, (64, 64, 64)),
                 ((7, 1, True), (16, 4), 2, (37, 45, 53)),
                 ((7, 1, True), (64, 64), 2, (64, 64, 64)),
                 ((5, 2, True), (16, 4), 10, (64, 64, 64))]
GENERIC_KERNELS = ("stencil_attention_generic_kernel",
                   "stencil_attention_scal_generic_kernel",
                   "stencil_attention_bwd_plus_kernel",
                   "stencil_attention_bwd_minus_kernel")


def generic_plans(B, grid, F, G, offs):
    """(name, plan, blocks an SM holds) of each plane-ring launch of the
    generic forward and gradient pass on these operands."""
    wa = window_attention
    lib = _build.load()
    cls = {(1, 4, 1): 0, (1, 4, 4): 1, (4, 4, 4): 2}[wa.generic_class(F, G)]
    h = wa.generic_halo(offs)
    fwd = wa.generic_fwd_plan(B, *grid, F, G, h)
    bwd = wa.generic_bwd_plan(B, *grid, F, G, h)
    return [("forward", fwd, lib.stencil_attention_generic_occupancy(
        cls, fwd["threads"], fwd["smem"]))] + [
        (f"gradient {side}", bwd[side],
         lib.stencil_attention_bwd_generic_occupancy(
             int(side == "minus"), cls, bwd[side]["threads"],
             bwd[side]["smem"])) for side in ("plus", "minus")]


def generic_pass_work(kind, F, G, voxels, edges):
    """(bytes, flops) of one pass: each input read once and each output
    written once; per valid edge the operations the function needs, each
    once, as stencil_attention_*_plain computes them (the gradient pass
    computes the logit's dot and u's dot again on its -o side, which the
    bound does not count): the forward's logit dot 2F
    and aggregate 2G; the statistics pass's logit dot 2F and u's dot 2G;
    the gradient pass's logit dot 2F, u's dot 2G and its three
    accumulations ds phi, ds theta and a ybar (2F, 2F, 2G); a few scalar
    operations an edge for the logit, the softmax weight and ds."""
    if kind == "fwd":
        return 4 * voxels * (2 * F + 2 * G), edges * (2 * F + 2 * G + 6)
    if kind == "scal":
        return 4 * voxels * (2 * F + 2 * G + 4), edges * (2 * F + 2 * G + 8)
    return 4 * voxels * (4 * F + 3 * G + 4), edges * (6 * F + 4 * G + 8)


def generic_attention_phase(gen):
    """Each generic stencil-attention kernel (forward, statistics and
    gradient passes; csrc/stencil_attention_generic.cu) at every case of
    GENERIC_CASES: each output (each of the statistics pass's four
    channels r, m, denom, c on its own) against its plain version within
    1e-4 of that output's largest value, on inputs on a 1/8 grid (every
    dot product exact in f32),
    launched twice with bitwise-equal results, timed per launch over
    ATT_REPEAT launches back to back beside its bound; at batch 2 also
    StencilAttentionFunction's gradients against autograd through the
    plain forward (1e-4). Returns the kernels line's records (variant
    A's shape, the last case)."""
    wa = window_attention
    ptxas_report(GENERIC_KERNELS)
    rel = lambda yp: 1e-4 * yp.abs().max().item()  # noqa: E731
    res = {}
    for stencil, (F, G), B, grid in GENERIC_CASES:
        offs = wa.stencil_offsets(*stencil)
        th, ph = (torch.round(torch.randn(B, *grid, F, generator=gen,
                                          device="cuda") * 8) / 8
                  for _ in range(2))
        g, yb = (torch.round(torch.randn(B, *grid, G, generator=gen,
                                         device="cuda") * 8) / 8
                 for _ in range(2))
        edges = B * int(wa.valid_masks(grid, offs).sum())
        voxels = B * grid[0] * grid[1] * grid[2]
        scal = wa.stencil_attention_scal_plain(th, ph, g, yb, offs)
        passes = (("fwd", "stencil_attention_generic",
                   wa.stencil_attention_plain, (th, ph, g, offs)),
                  ("scal", "stencil_attention_scal_generic",
                   wa.stencil_attention_scal_plain, (th, ph, g, yb, offs)),
                  ("bwd", "stencil_attention_bwd_generic",
                   wa.stencil_attention_bwd_plain,
                   (th, ph, g, yb, scal, offs)))
        tag = (f"k={stencil[0]} c={stencil[1]} self loop {stencil[2]} "
               f"({len(offs)} offsets), F={F} G={G}, {B}x"
               + ("64^3" if grid == (64, 64, 64) else "x".join(map(str, grid))))
        for name, p, per_sm in generic_plans(B, grid, F, G, offs):
            print(f"# generic attention {name} plan {tag}: tile {p['run']}, "
                  f"{p['sets']} sets, "
                  f"{'reload' if p['reload'] else 'whole'} ring of "
                  f"{p['nbuf']}, {p['lanes']} lanes a voxel, {p['threads']} "
                  f"threads, {p['blocks']} blocks, {p['smem']} bytes of "
                  f"dynamic shared memory, {per_sm} blocks an SM",
                  flush=True)
            if per_sm < 1:
                fail(f"generic attention {name} {tag}: no block fits an SM")
        for kind, name, plain, args in passes:
            fn = getattr(wa, name)
            split = (lambda t: t.unbind(-1)) if kind == "scal" else _outputs
            with torch.no_grad():
                y, yp, y2 = (split(f(*args)) for f in (fn, plain, fn))
                torch.cuda.synchronize()
                errs = [(a - b).abs().max().item() for a, b in zip(y, yp)]
                allows = [rel(b) for b in yp]
                err = max(errs)
                same = all(torch.equal(a, b) for a, b in zip(y, y2))
                ms = cuda_ms(lambda: [fn(*args) for _ in range(ATT_REPEAT)]) \
                    / ATT_REPEAT
                plain_ms = cuda_ms(lambda: plain(*args), reps=3)
            nb, ops = generic_pass_work(kind, F, G, voxels, edges)
            bound_ms, bound_by = bound(nb, ops, F32_FLOPS)
            print(f"# generic attention {kind} {tag}: max_abs_err "
                  + ", ".join(f"{e:.3g} (allowed {al:.3g})"
                              for e, al in zip(errs, allows))
                  + ", repeat "
                  f"{'bitwise equal' if same else 'DIFFERS'}; ms {ms:.4f}, "
                  f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}), {100 * bound_ms / ms:.1f}% of it",
                  flush=True)
            if not all(e <= al for e, al in zip(errs, allows)):
                fail(f"generic attention {kind} {tag}: disagrees with its "
                     "plain version")
            if not same:
                fail(f"generic attention {kind} {tag}: two launches differ "
                     "bitwise")
            res[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": None}
            del y, yp, y2
        if B == 2:
            leaves = [t.clone().requires_grad_() for t in (th, ph, g)]
            got = torch.autograd.grad(wa.stencil_attention(*leaves, offs),
                                      leaves, yb)
            want = torch.autograd.grad(
                wa.stencil_attention_plain(*leaves, offs), leaves, yb)
            for gname, a, b in zip(("dtheta", "dphi", "dg"), got, want):
                e = (a - b).abs().max().item()
                print(f"# generic attention StencilAttentionFunction {gname} "
                      f"{tag} vs autograd of the plain forward: max_abs_err "
                      f"{e:.3g} (allowed {rel(b):.3g})", flush=True)
                if not e <= rel(b):
                    fail(f"StencilAttentionFunction {gname} disagrees with "
                         f"autograd ({tag})")
            del leaves, got, want
        del th, ph, g, yb, scal
        torch.cuda.empty_cache()
    return res


# variant A: the flagship with a k = 5, connectivity-2, self-loop PCM (98
# offsets, asymmetric, halo 2) of widths F = 16 (a 33-channel PCM input) and
# G = 4; VARIANT_GEO its second PCM, with the positional encoding
VARIANT_A = dict(at_k_size=5, at_connectivity=2, at_self_loop=True,
                 at_f_dim=16, at_g_dim=4)
VARIANT_GEO = dict(at_merge_type="scaled_dot_product_geo_relu",
                   at_p_enc_dim=24, at_geo_f_dim=8)


def variant_a(**pcm):
    return with_settings(st_dram_ref_att, MODEL=dict(
        st_dram_ref_att.MODEL, **VARIANT_A, **pcm))


def variant_b():
    """Variant B: 'in' norms, PReLU, dropout 0.1, HeNorm fan_out, Adam with
    weight decay 1e-4 and an attention_module group at lr 1e-3,
    IntRegAffRefineLoss with a rescale pool of 64 / 80 / 96 (each halves
    evenly three times for the pools)."""
    loss = {k: v for k, v in st_dram_ref_att.LOSS_FUNC.items()
            if k != "method"}
    return with_settings(
        st_dram_ref_att,
        MODEL=dict(st_dram_ref_att.MODEL, norm_method="in",
                   act_method="prelu", dropout=0.1),
        INITIALIZER={"method": "models.HeNorm", "mode": "fan_out"},
        OPTIMIZER=dict(st_dram_ref_att.OPTIMIZER, weight_decay=1e-4,
                       groups={"attention_module": {"lr": 1e-3}}),
        LOSS_FUNC=dict(loss, method="metrics.IntRegAffRefineLoss",
                       rescale_jitter=[64, 80, 96]))


def variant_model(settings, bench, dtype=torch.bfloat16):
    """The model of `settings` initialised by its INITIALIZER from
    RANDOM_SEED and, with `bench`, the trained flagship's backbone over
    it (fresh tap heads and PCM)."""
    m = build_model(settings, dtype)
    init = dict(settings.INITIALIZER)
    get_callable_by_name(init.pop("method"))(**init)(
        m, torch.Generator().manual_seed(settings.RANDOM_SEED))
    if bench is not None:
        weights.load_backbone(m.backbone, bench)
    return m


def pipeline_generic_phase(prepc, bench, launches):
    """Variant A's scan: process_chunks with the kernels (launch counts of
    pipeline_generic zeroed just before, read just after: the generic
    attention forward, not the plane ring), then with the plain
    versions; pred masks at Dice >= 0.99."""
    pipe = FastScanPipeline(variant_model(variant_a(), bench), device="cuda")
    zero_counts()
    k = run_scan(pipe, prepc, False, "variant A kernels")
    launches["pipeline_generic"] = path_counts(
        "pipeline_generic", {"stencil_attention_generic": 1})
    print(f"# launches over variant A's scan: {launches['pipeline_generic']}",
          flush=True)
    with plain_versions():
        p = run_scan(pipe, prepc, False, "variant A plain versions")
    d = dice(k["pred"], p["pred"])
    print(f"# variant A scan, kernels vs plain on the card: pred Dice {d:.6f} "
          "(limit 0.99)", flush=True)
    if not d >= 0.99:
        fail("variant A's scan disagrees with the plain versions")


def variant_buffers(settings, bench):
    def initial():
        return dict(variant_model(settings, bench, torch.float32)
                    .named_buffers())
    return initial


def variant_b_epochs_phase(root, card):
    """The training CLI's main on variant B over the synthetic dataset of
    train epochs: one epoch from INITIALIZER (validated, checkpointed),
    then a resume (RELOAD_CHECKPOINT: model, optimizer, metrics) whose
    optimizer state equals the checkpoint's bitwise, with NUM_EPOCHS = 2:
    the loop restarts the checkpoint's epoch, so epochs 0 and 1.
    Gates: finite losses, 0.ckpt and 1.ckpt, the checkpoint's optimizer
    in dram_tpu's multi_transform layout (groups attention_module and
    __default__, AdamW's weight_decay), every group's lr at its base *
    gamma after one validation, every kernel of the path launched and no
    other. Prints each epoch's peak MiB."""
    db = f"{root}/db"
    vb = variant_b()
    path = epoch_settings(root, db, epoch_label_count(db), EXP_NAME="variant_b",
                          NUM_EPOCHS=1, MODEL=vb.MODEL,
                          INITIALIZER=vb.INITIALIZER, OPTIMIZER=vb.OPTIMIZER,
                          LOSS_FUNC=vb.LOSS_FUNC)
    smp = f"{root}/variant_b_settings.py"
    os.replace(path, smp)
    zero_counts()
    runner = train_main(["0", str(vb.OPTIMIZER["lr"]), "--batch_size", "10",
                         "--smp", smp, "--device", "cuda"])
    torch.cuda.synchronize()
    launches = {"variant_b_epochs": path_counts("variant_b_epochs")}
    print_epochs(runner, "variant B epochs", card)
    ckpt = runner.exp_path + "0.ckpt"
    if not os.path.exists(ckpt) or len(runner.history) != 1:
        fail("variant B epochs: one epoch and 0.ckpt")
    saved = load_checkpoint(ckpt)
    groups = saved["optimizer"].get("inner_states", {})
    if sorted(groups) != ["__default__", "attention_module"] or any(
            "weight_decay" not in g["inner_state"]["hyperparams"]
            for g in groups.values()):
        fail(f"variant B epochs: optimizer layout {sorted(groups)}")
    sch = runner.scheduler
    lrs = {g["label"]: g["lr"] for g in runner.optimizer.param_groups}
    want = {"__default__": vb.OPTIMIZER["lr"] * sch.gamma,
            "attention_module": 1e-3 * sch.gamma}
    if any(abs(lrs[k] - v) > 1e-12 for k, v in want.items()):
        fail(f"variant B epochs: group lrs {lrs}, expected {want}")
    print(f"# variant B epochs: launches {launches['variant_b_epochs']}; "
          f"optimizer groups {sorted(groups)} (AdamW, weight_decay "
          f"{vb.OPTIMIZER['weight_decay']}), lrs {lrs} after "
          f"{sch.steps} scheduler step", flush=True)
    s = Settings(smp)
    s.RELOAD_CHECKPOINT, s.RELOAD_CHECKPOINT_PATH = True, None
    s.RELOAD_DICT_LIST = ["model", "optimizer", "metrics"]
    s.NUM_EPOCHS = 2
    again = LesionSegChunkTrain(s, device="cuda")
    have = optimizer_state_tree(again.optimizer, again.model)

    def leaves(tree, prefix=""):
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield prefix + k, np.asarray(v)
    want_t, have_t = dict(leaves(saved["optimizer"])), dict(leaves(have))
    if want_t.keys() != have_t.keys() or not all(
            np.array_equal(v, have_t[k]) for k, v in want_t.items()):
        fail("variant B resume: the optimizer state differs from 0.ckpt's")
    zero_counts()
    again.run()
    torch.cuda.synchronize()
    launches["variant_b_resume"] = path_counts("variant_b_resume")
    print_epochs(again, "variant B resume", card)
    # the loop restarts the checkpoint's epoch (0), as dram_tpu's does
    if [e["epoch"] for e in again.history] != [0, 1] or \
            not os.path.exists(again.exp_path + "1.ckpt"):
        fail("variant B resume: epochs 0..1 and 1.ckpt")
    print(f"# variant B resume: {len(want_t)} optimizer arrays bitwise equal "
          f"to 0.ckpt's; epochs 0..1 trained, 1.ckpt written; launches "
          f"{launches['variant_b_resume']}", flush=True)
    return launches


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


# --- data parallelism on torch.distributed -----------------------------------

DP_WORLD = 2
BENCH = os.path.join(ROOT, "assets", "bench_weights.ckpt.xz")
# the train dp gate: each step's parameters against the one-process run's,
# the worst relative L2 of the difference over the update (p_ref - p_0)
# of a tensor, placed between the sound readings (0.0731 / 0.125, train
# dp / train dp pad) and those of broken data-parallel code (one stack's
# statistics local 0.918-1.06, the padded row at weight 1 0.40-0.50;
# gradients summed, not averaged, read 0.0732: Adam hides the factor 2,
# the gradient gate catches it; PERF.md, tools/train_gate_mutants.py --dp)
DP_UPDATE_REL_L2 = 0.3
# overlap tiles of the flagship backbone (DC3D, local upsample): four
# tiles of 40 planes in windows of 136 (halo 48, enough for its
# receptive field) over 2 x 160 x 80 x 80
OVERLAP_SHAPE, OVERLAP_TILES, OVERLAP_HALO = (2, 160, 80, 80), 4, 48


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def rank_local_norms(world):
    """The one-process reference of a data-parallel step: a BatchNorm that
    dram_tpu keeps local to a rank (cross_rank False: DC3DATGeneric's tap
    heads) normalises each rank's rows of the batch with their own
    statistics, and its running statistics move with rank 0's."""
    from dram_tpu_torch.models.blocks import BatchNorm
    forward = BatchNorm.forward

    def local(self, x):
        if self.cross_rank or not self.training:
            return forward(self, x)
        r0 = (self.running_mean.clone(), self.running_var.clone())
        outs = []
        for i, part in enumerate(x.chunk(world)):
            outs.append(forward(self, part))
            if i == 0:
                first = (self.running_mean.clone(), self.running_var.clone())
            with torch.no_grad():
                self.running_mean.copy_(r0[0])
                self.running_var.copy_(r0[1])
        with torch.no_grad():
            self.running_mean.copy_(first[0])
            self.running_var.copy_(first[1])
        return torch.cat(outs)
    BatchNorm.forward = local
    try:
        yield
    finally:
        BatchNorm.forward = forward


def dp_batch(n_real, pad):
    """The train att phase's batch (10 x 80^3, -1000..-700 HU) cut to its
    first `n_real` rows, packed for the u16 wire, padded to 10 rows by
    `pad` (arrays, n) -> (arrays, weights)."""
    s = st_dram_ref_att
    batch = train_batch(SEED, batch=s.TRAIN_BATCH_SIZE,
                        size=s.RESAMPLE_SIZE[0],
                        window=(s.WINDOWING_MIN, s.WINDOWING_MAX))
    packed = pack_train_batch(batch, "u16")
    keys = ("images", "span", "lobes", "lesions", "ctss")
    arrays, w = pad(tuple(packed[k][:n_real] for k in keys), DP_WORLD)
    return dict(packed, **dict(zip(keys, arrays)), weights=w,
                ctss_frequency=batch["ctss_frequency"])


def explicit_pad(arrays, world):
    """The reference's padding, written out (not mesh.pad_batch): rows
    wrap around to 10, the added rows at weight 0."""
    n = arrays[0].shape[0]
    idx = np.arange(st_dram_ref_att.TRAIN_BATCH_SIZE) % n
    return (tuple(a[idx] for a in arrays),
            (np.arange(len(idx)) < n).astype(np.float32))


def dp_train_run(batch, device, group, keep_params):
    """TRAIN_STEPS steps of the flagship from its trained tree on `batch`
    (this rank's rows and weights under a group): per step the loss
    terms, ms and peak MiB; step 1's gradients (after the cross-rank
    mean) and buffers; with `keep_params` the parameters after each step;
    a float64 fingerprint of the last ones."""
    rec = {"params": []}

    def on_step(i, step, r):
        if i == 0:
            rec["grads"] = {n: p.grad.detach().float().cpu().clone()
                            for n, p in step.model.named_parameters()}
            rec["buffers"] = {n: b.detach().cpu().clone()
                              for n, b in step.model.named_buffers()}
        if keep_params:
            rec["params"].append({n: p.detach().float().cpu().clone()
                                  for n, p in step.model.named_parameters()})
    out = train_steps(st_dram_ref_att, TRAIN_STEPS, [batch], device=device,
                      weights_path=BENCH, on_step=on_step, group=group)
    rec.update(losses=out["losses"], loss=out["loss"], ms=out["ms"],
               peak_mib=out["peak_mib"], fingerprint=torch.stack(
                   [p.detach().double().sum() for p in
                    out["step"].model.parameters()]).cpu())
    return rec


def dp_rank_train(rank, group, device):
    """The ranks' side of train dp and train dp pad: each rank takes its
    rows of the padded global batch (mesh.pad_batch) and runs the steps;
    launch counts zeroed before each run and read after (path
    train_dp)."""
    res = {}
    for n_real in (10, 9):
        batch = dp_batch(n_real, mesh.pad_batch)
        per = len(batch["weights"]) // DP_WORLD
        local = {k: (v[rank * per:(rank + 1) * per]
                     if isinstance(v, np.ndarray) and v.ndim
                     and v.shape[0] == 2 * per else v)
                 for k, v in batch.items()}
        zero_counts()
        rec = dp_train_run(local, device, group, rank == 0)
        torch.cuda.synchronize()
        rec["counts"] = path_counts("train_dp")
        res[n_real] = rec
        torch.cuda.empty_cache()
    return res


def pcm_inputs(pcm, device):
    """cam (5, 64^3, 1) and f (5, 64^3, in_ch), f32, from SEED."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    size = (5,) + tuple(DC3DATGeneric().at_spatial_size)
    cam = torch.randn(size + (1,), generator=gen, device=device)
    f = torch.relu(torch.randn(size + (pcm.theta.in_features,),
                               generator=gen, device=device))
    return cam, f


def overlap_input(device):
    """(2, 160, 80, 80, 1): pairs of the train batch's chunks stacked in
    depth."""
    x = torch.from_numpy(train_batch(SEED, batch=4, size=80,
                                     window=WINDOW)["#image"])
    return x.reshape(OVERLAP_SHAPE + (1,)).to(device)


def overlap_model(device):
    model = DC3D(stacking=st_dram_ref.MODEL["stacking"], local_upsample=True,
                 dtype=torch.bfloat16)
    return weights.load_backbone(model, BENCH).to(device).eval()


def dp_rank_context(rank, group, device):
    """The ranks' side of pcm sharded (the flagship's PCM over the ranks:
    the plain path, no kernel launch) and overlap tile (the flagship
    backbone with a local upsample, path overlap_tile)."""
    from dram_tpu_torch.models.pcm import pcm_sharded
    pcm = weights.load_into(DC3DATGeneric(), *weights.load_bench_weights(
        BENCH)).attention_module.to(device)
    cam, f = pcm_inputs(pcm, device)
    zero_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        out = pcm_sharded(pcm, cam, f, group)
        torch.cuda.synchronize()
        pcm_ms = (time.perf_counter() - t0) * 1e3
    path_counts("pcm_sharded")
    res = {"pcm": out.cpu(), "pcm_ms": pcm_ms}
    del pcm, cam, f, out
    model = overlap_model(device)
    x = overlap_input(device)
    zero_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        dense, refined = mesh.overlap_tile_infer(
            lambda xb, lb: model(xb), x, x, OVERLAP_TILES, OVERLAP_HALO,
            group)
        torch.cuda.synchronize()
        res["overlap_ms"] = (time.perf_counter() - t0) * 1e3
    res["overlap_counts"] = path_counts("overlap_tile")
    res["dense"] = dense.cpu()
    return res


DP_JOBS = {"train": dp_rank_train, "context": dp_rank_context}


def dp_rank(rank, world, port, job, limit, out_dir, bench):
    """One rank (a spawned process): joins the gloo group through the
    environment torchrun sets, on the card it shares, runs `job` under
    its own watchdog (the trained weights at `bench`) and saves the
    result for the parent."""
    global BENCH
    BENCH = bench
    faulthandler.dump_traceback_later(limit, exit=True)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh.maybe_init_distributed("cuda")
    group = mesh.data_group()
    device = mesh.local_device("cuda")
    _build.load()
    res = DP_JOBS[job](rank, group, device)
    res.update(backend=torch.distributed.get_backend(group),
               device=str(device), gpus=torch.cuda.device_count())
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def run_ranks(job, limit):
    """Spawn DP_WORLD ranks of `job` and return their results; a rank that
    fails or outlives `limit` fails the phase (the others are ended)."""
    ctx = torch.multiprocessing.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as d:
        procs = [ctx.Process(target=dp_rank,
                             args=(r, DP_WORLD, port, job, limit, d, BENCH))
                 for r in range(DP_WORLD)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + limit + 30
        while any(p.is_alive() for p in procs) and \
                time.monotonic() < deadline and \
                not any(p.exitcode not in (None, 0) for p in procs):
            time.sleep(0.5)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode}
        if bad:
            fail(f"{job}: ranks failed (rank: exit code) {bad}")
        out = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
               for r in range(DP_WORLD)]
    used = {(o["backend"], o["device"], o["gpus"]) for o in out}
    print(f"# {job}: {DP_WORLD} ranks over "
          + ", ".join(f"{b} on {dev} ({g} GPU{'s' * (g != 1)} visible)"
                      for b, dev, g in sorted(used))
          + ("; the ranks share one card" if len(used) == 1 else ""),
          flush=True)
    return out


def compare_dp(ranks, ref, initial, label):
    """Data-parallel ranks vs the one-process run: the ranks' parameters
    bitwise equal; each rank's launches, step ms and peak; every step's
    loss terms; step 1's gradients and BatchNorm statistics by the train
    gate (compare_train); each step's parameters by DP_UPDATE_REL_L2 (but
    those whose gradient is zero in exact arithmetic: Adam steps them on
    rounding alone). Every reading is printed before a failure."""
    fp = ranks[0]["fingerprint"]
    if not all(torch.equal(r["fingerprint"], fp) for r in ranks[1:]):
        fail(f"{label}: the ranks' parameters differ after the steps")
    for r, res in enumerate(ranks):
        print(f"# {label} rank {r}: launches {res['counts']}; step ms "
              + ", ".join(f"{sum(m.values()):.1f}" for m in res["ms"])
              + f"; peak {max(res['peak_mib']):.0f} MiB", flush=True)
    print(f"# {label} one process (reference): step ms "
          + ", ".join(f"{sum(m.values()):.1f}" for m in ref["ms"])
          + f"; peak {max(ref['peak_mib']):.0f} MiB", flush=True)
    failed = []
    for i in range(TRAIN_STEPS):
        a, b = ranks[0]["losses"][i], ref["losses"][i]
        rel = max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))
        print(f"# {label} step {i + 1}: loss terms {a} vs {b} (rel "
              f"{rel:.3g}, allowed {LOSS_RTOL})", flush=True)
        if not rel <= LOSS_RTOL:
            failed.append(f"step {i + 1}'s loss terms")
    try:
        compare_train(dict(ranks[0], losses=ranks[0]["losses"][0]),
                      dict(ref, losses=ref["losses"][0]), initial["buffers"],
                      label)
    except SystemExit:
        failed.append("step 1's gradients or statistics")
    for i, (pd, pr) in enumerate(zip(ranks[0]["params"], ref["params"])):
        rl2 = {n: ((pd[n] - pr[n]).norm() / (pr[n] - initial["params"][n])
                   .norm().clamp(min=1e-30)).item() for n in pr
               if not zero_in_exact_arithmetic(n)}
        worst = max(rl2, key=rl2.get)
        print(f"# {label} parameters after step {i + 1}: worst relative L2 "
              f"of the difference over the update {rl2[worst]:.3g} ({worst},"
              f" allowed {DP_UPDATE_REL_L2}), median "
              f"{float(np.median(list(rl2.values()))):.3g}", flush=True)
        if not rl2[worst] <= DP_UPDATE_REL_L2:
            failed.append(f"the parameters after step {i + 1}")
    if failed:
        fail(f"{label} disagrees with the one-process step: "
             + ", ".join(failed))


def train_dp_phases(launches, compare=compare_dp):
    """Phases train dp and train dp pad: DP_WORLD gloo ranks on the card
    run the flagship's step on their rows of the global batch (10 rows;
    then 9 padded to 10 with one wrap-around row of weight 0), each held
    against the one-process step on the same padded batch and weights
    from the same start, dram_tpu's local tap-head statistics emulated
    (rank_local_norms), by `compare` (compare_dp)."""
    start = weights.load_into(DC3DATGeneric(),
                              *weights.load_bench_weights(BENCH))
    initial = {"buffers": dict(start.named_buffers()),
               "params": {n: p.detach().float().clone()
                          for n, p in start.named_parameters()}}
    del start
    torch.cuda.empty_cache()
    with phase("train dp", LIMITS["train_dp"]):
        ranks = run_ranks("train", LIMITS["train_dp"] - 60)
        with rank_local_norms(DP_WORLD):
            ref = dp_train_run(dp_batch(10, explicit_pad), "cuda", None,
                               True)
        compare([r[10] for r in ranks], ref, initial, "train dp")
        torch.cuda.empty_cache()
    with phase("train dp pad", LIMITS["train_dp_pad"]):
        with rank_local_norms(DP_WORLD):
            ref = dp_train_run(dp_batch(9, explicit_pad), "cuda", None, True)
        compare([r[9] for r in ranks], ref, initial, "train dp pad")
        torch.cuda.empty_cache()
    launches["train_dp"] = {k: sum(r[n]["counts"][k] for r in ranks
                                   for n in (10, 9))
                            for k in PATHS["train_dp"]}


def context_parallel_phases(launches):
    """Phases pcm sharded and overlap tile: the ranks' results of
    dp_rank_context against the one-process forwards (the PCM on the
    plane-ring kernel, within 1e-4 of the largest; the backbone's whole
    volume, within 2^-7 of the largest)."""
    with phase("pcm sharded", LIMITS["pcm_sharded"]):
        ranks = run_ranks("context", LIMITS["pcm_sharded"] - 30)
        pcm = weights.load_into(DC3DATGeneric(), *weights.load_bench_weights(
            BENCH)).attention_module.cuda()
        cam, f = pcm_inputs(pcm, "cuda")
        with torch.no_grad():
            want = pcm(cam, f).cpu()
        for r, res in enumerate(ranks):
            err = (res["pcm"] - want).abs().max().item() / \
                want.abs().max().item()
            print(f"# pcm sharded rank {r}: {tuple(want.shape)} over "
                  f"{DP_WORLD} ranks (the plain path, halo 1) vs the "
                  f"unsharded PCM on the plane-ring kernel: error {err:.3g} "
                  f"of the largest (allowed 1e-4); {res['pcm_ms']:.1f} ms",
                  flush=True)
            if not err <= 1e-4:
                fail("pcm sharded disagrees with the unsharded PCM")
        del pcm, cam, f, want
        torch.cuda.empty_cache()
    with phase("overlap tile", LIMITS["overlap_tile"]):
        model = overlap_model("cuda")
        with torch.no_grad():
            want, _ = model(overlap_input("cuda"))
        want = want.cpu()
        for r, res in enumerate(ranks):
            err = (res["dense"] - want).abs().max().item() / \
                want.abs().max().item()
            print(f"# overlap tile rank {r}: {OVERLAP_SHAPE} in "
                  f"{OVERLAP_TILES} tiles (halo {OVERLAP_HALO}) over "
                  f"{DP_WORLD} ranks vs the unsharded forward: error "
                  f"{err:.3g} of the largest (allowed 2^-7), "
                  f"{'bitwise equal' if torch.equal(res['dense'], want) else 'not bitwise equal'}; "
                  f"{res['overlap_ms']:.1f} ms; launches "
                  f"{res['overlap_counts']}", flush=True)
            if not err <= 2.0 ** -7:
                fail("overlap tiles disagree with the unsharded forward")
        del model
        torch.cuda.empty_cache()
    launches["overlap_tile"] = {k: sum(r["overlap_counts"][k] for r in ranks)
                                for k in PATHS["overlap_tile"]}


def engine_shard_phase(root, card):
    """LesionSegTest with SHARD_SCANS = 2 over the engine split, on two
    cards where there are two, else cuda:0 twice (two scans in flight on
    one card): every archived mask, post mask and heatmap equal to the
    serial engine phase's bit for bit, the same records; the chunk
    wire's forward kernels launched (path engine_shard)."""
    n_gpus = torch.cuda.device_count()
    devices = ["cuda:0", "cuda:1"] if n_gpus >= 2 else ["cuda:0", "cuda:0"]
    settings = engine_settings(root, SHARD_SCANS=2)
    out = f"{root}/engine_shard"
    eng = LesionSegTest(settings, output_path=out, device="cuda",
                        devices=devices)
    if eng._shard_count() != 2:
        fail(f"engine shard: {eng._shard_count()} scans in flight")
    print(f"# engine shard: 2 scans in flight on {devices} ({n_gpus} "
          f"GPU{'s' * (n_gpus != 1)} visible), no process group", flush=True)
    zero_counts()
    t0 = time.perf_counter()
    with error_log(settings) as errors:
        rows = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = path_counts("engine_shard")
    print(f"# engine shard: {len(rows)} scans in {wall:.2f} s wall; "
          f"launches {counts}", flush=True)
    print_scan_times(eng, "sharded", card)
    if not any(f"({ENGINE_TRUNCATED})" in e for e in errors):
        fail(f"engine shard: the truncated scan was not logged ({errors})")
    with open(f"{root}/engine/test/records.csv") as fp:
        serial = list(csv.DictReader(fp))
    if [r["uid"] for r in rows] != [r["uid"] for r in serial] or any(
            abs(float(a[k]) - float(b[k])) > 0
            for a, b in zip(rows, serial) for k in ("dice", "iou")):
        fail(f"engine shard: records {rows} differ from {serial}")
    for uid in ENGINE_GOOD:
        for sub in ("", "post/", "heatmap/"):
            a = read_mha(f"{out}/test/{sub}{uid}.mha")["array"]
            b = read_mha(f"{root}/engine/test/{sub}{uid}.mha")["array"]
            if not np.array_equal(a, b):
                fail(f"engine shard: {sub}{uid}.mha differs from the "
                     "serial run's")
    print(f"# engine shard: scan-sharded == serial masks, post masks and "
          f"heatmaps bit for bit ({len(ENGINE_GOOD)} scans)", flush=True)
    return counts


def main():
    with phase("card", LIMITS["card"]):
        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is false: this script needs an "
                 "NVIDIA GPU")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        card = smi.stdout.strip().splitlines()[0]
        print(card, flush=True)
        print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]}", flush=True)
        # reference math in full f32: no TF32 in cuDNN convs or matmuls
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    with phase("build", LIMITS["build"]), \
            concurrent.futures.ThreadPoolExecutor(1) as ex:
        cold = not os.path.exists(_build.library_path())
        host = ex.submit(load_host_prep)
        _build.load()
        host_build = host.result()
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
        # the NumPy prep: the golden's chunks come from it
        t0 = time.perf_counter()
        prepc = prep_scan_chunks(scan, lobe, SPACING, vessel_u8=vessel,
                                 windowing_span=WINDOW, prep="numpy")
        prep_ms = (time.perf_counter() - t0) * 1e3
        print(f"# host prep (NumPy) {prep_ms:.1f} ms: scan {SCAN_SHAPE} at "
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
        launches["pipeline_unfused"] = path_counts(
            "pipeline_unfused", {"conv3d": 2 * 13, "conv3x3x3_c1": 2})
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

    with phase("pipeline generic", LIMITS["pipeline_generic"]):
        pipeline_generic_phase(prepc, os.path.join(
            ROOT, "assets", "bench_weights.ckpt.xz"), launches)
    torch.cuda.empty_cache()

    del upipe
    torch.cuda.empty_cache()
    with phase("host prep", LIMITS["host_prep"]):
        preps = host_prep_phase((scan, lobe, vessel), prepc, prep_ms,
                                host_build)
    native_heat = wire_phases(pipe, (scan, lobe, vessel), preps, launches)
    del preps
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_engine_") as root:
        with phase("engine", LIMITS["engine"]):
            launches["engine"], ckpt = engine_phase(root, params,
                                                    batch_stats, card)
        with phase("engine w8", LIMITS["engine_w8"]):
            launches["engine_w8"] = engine_w8_phase(root, card)
        deploy = write_deploy_dirs(root, scan, lobe)
        with phase("engine deploy", LIMITS["engine_deploy"]):
            engine_deploy_phase(root, ckpt, deploy, pipe, native_heat, card)
        torch.cuda.empty_cache()
        with phase("engine host-stitch", LIMITS["engine_stitch"]):
            engine_stitch_phase(root, ckpt, deploy, card)
        torch.cuda.empty_cache()
        with phase("engine shard", LIMITS["engine_shard"]):
            launches["engine_shard"] = engine_shard_phase(root, card)
    del pipe, model, prepc
    torch.cuda.empty_cache()
    res.update(train_kernel_phases(gen))
    torch.cuda.empty_cache()
    res.update(unfused_kernel_phases(gen))
    torch.cuda.empty_cache()
    res.update(entry_kernel_phases(gen))
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
    with phase("generic attention", LIMITS["generic_attention"]):
        res.update(generic_attention_phase(gen))
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
        expect={"conv3d": 13, "conv3d_dx": 13, "conv3d_dw": 13,
                "conv3x3x3_c1": 1, "conv3x3x3_c1_dw": 1,
                "maxpool2_bwd_first": 3})
    check_head_grads(uk_run, "unfused kernels")
    check_head_grads(up_run, "unfused plain versions")
    unfused_vs_fused(k_run, uk_run)
    del k_run, uk_run, up_run
    torch.cuda.empty_cache()

    va = variant_a()
    gk, gp = train_phases(va, "train_generic", bench,
                          variant_buffers(va, bench), launches,
                          backbone_only=True)
    check_head_grads(gk, "generic kernels")
    check_head_grads(gp, "generic plain versions")
    del gk, gp
    torch.cuda.empty_cache()
    geo = variant_a(**VARIANT_GEO)
    ok, op = train_phases(geo, "train_geo", bench, variant_buffers(geo, bench),
                          launches, backbone_only=True, steps=1)
    check_head_grads(ok, "geo kernels", 20)
    del ok, op
    torch.cuda.empty_cache()
    vb = variant_b()
    bk, bp = train_phases(vb, "train_variant_b", None,
                          variant_buffers(vb, None), launches)
    check_head_grads(bk, "variant B kernels")
    print(f"# train variant B: peak {bk['peak_mib']:.0f} MiB over its "
          f"{TRAIN_STEPS} steps (two forwards a step, the rescale up to "
          f"96^3) ({card})", flush=True)
    del bk, bp
    torch.cuda.empty_cache()

    with phase("train golden", LIMITS["train_golden"]):
        train_golden_phase(bench, launches,
                           (("train_golden", st_dram_ref_att),
                            ("train_golden_unfused", unfused)))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_epochs_") as root:
        bench_params, bench_stats = weights.load_bench_weights(bench)
        with phase("train epochs", LIMITS["train_epochs"]):
            launches["train_epochs"], first, smp, trained = \
                train_epochs_phase(root, bench_params, bench_stats, card)
        with phase("train val paths", LIMITS["train_val_paths"]):
            train_val_paths_phase(smp, trained, card)
        torch.cuda.empty_cache()
        with phase("train resume", LIMITS["train_resume"]):
            train_resume_phase(smp, first, card)
        del first
        torch.cuda.empty_cache()
        with phase("variant b epochs", LIMITS["variant_b_epochs"]):
            launches.update(variant_b_epochs_phase(root, card))
        torch.cuda.empty_cache()

    train_dp_phases(launches)
    context_parallel_phases(launches)

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

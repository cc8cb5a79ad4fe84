"""Align-corners 2x trilinear upsample on NDHWC volumes, and its adjoint.

Port of the decoder upsample of the JAX package: dram_tpu/core/pallas/
upsample.py:up2_depth_flat (forward; backward _bwd_call) and the in-plane
einsum passes of core/pallas/cm.py:upsample2x_cm with the adjoints XLA
derives from them, each direction done in one pass. CUDA source:
csrc/upsample2x.cu.

The launch geometry of both kernels is decided here (fwd_plan, bwd_plan):
a block owns a tile of (batch element, run of z-planes, run of rows, run
of columns, all channels) and streams it along z, staging the rows it
reads into shared memory one bulk copy per row. The plans check the
assumptions the kernels' register windows make about the tap tables
(`axis_taps`, the f32 arithmetic of the kernels' per-block tables) and
raise where a tile plan would leave an output uncovered; the C launchers
run the `args` vector they are handed and refuse one that does not
cover the output.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

# outputs (forward) / inputs (adjoint) a thread owns along x: the kernels'
# compile-time register windows (csrc/upsample2x.cu: FWD_SX, BWD_SX)
FWD_SX, BWD_SX = 8, 4
# shared-memory plane buffers: the forward reads two input planes while it
# loads a third; the adjoint reads one dy plane while it loads the next
FWD_NBUF, BWD_NBUF = 3, 2
# per block: at most this much shared memory (two blocks fit on an SM)
# and this many threads (the kernels' __launch_bounds__: FWD_THREADS,
# BWD_THREADS, two blocks a SM; at 512 the forward spilled under its 64
# registers and ran 1.3-1.5x slower, tools/upsample_variants.py)
SMEM_BUDGET, FWD_THREADS, BWD_THREADS = 113 * 1024, 256, 256
# the plan wants WAVES waves of two blocks on each of the SMS SMs: on the
# card, blocks that stream fewer planes each ran faster than the fewest
# staged bytes alone would predict (tools/upsample_variants.py)
SMS, WAVES = 132, 6


def upsample2x_plain(x):
    """(B, D, H, W, C) -> (B, 2D, 2H, 2W, C): F.interpolate trilinear,
    align_corners=True, computed in f32 and returned in x's dtype."""
    y = F.interpolate(x.permute(0, 4, 1, 2, 3).float(), scale_factor=2,
                      mode="trilinear", align_corners=True)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


@functools.lru_cache(maxsize=64)
def axis_taps(n):
    """(lo, hi, f) of the 2n outputs of one axis, as lists: the kernels'
    f32 arithmetic, t = (f32(n-1) / f32(2n-1)) * o, lo = floor(t) (at most
    n - 1), hi = min(lo + 1, n - 1), f = t - lo."""
    scale = torch.tensor(n - 1, dtype=torch.float32) / (2 * n - 1) \
        if n > 1 else torch.tensor(0.0)
    t = scale * torch.arange(2 * n, dtype=torch.float32)
    lo = torch.clamp(torch.floor(t), max=n - 1)
    f = t - lo
    lo = lo.long()
    hi = torch.clamp(lo + 1, max=n - 1)
    return lo.tolist(), hi.tolist(), f.tolist()


@functools.lru_cache(maxsize=64)
def _check_axis(n):
    """Raise unless the register windows of csrc/upsample2x.cu hold along
    an axis of n inputs: output o reads inputs lo(o), hi(o) from the
    three-input window that starts at (o >> 1) - 1 (forward), input i
    gathers from outputs 2i - 1 .. 2i + 2 only (adjoint), and lo steps by
    0 or 1 from one output to the next (both stream z in order)."""
    lo, hi, f = axis_taps(n)
    for o in range(2 * n):
        base = (o >> 1) - 1
        if not (0 <= lo[o] - base <= 1 and hi[o] - base <= 2):
            raise ValueError(f"upsample2x: output {o} of an axis of {n} "
                             f"reads ({lo[o]}, {hi[o]}), outside the "
                             f"window from {base}")
        if o and not 0 <= lo[o] - lo[o - 1] <= 1:
            raise ValueError(f"upsample2x: lo steps from {lo[o - 1]} to "
                             f"{lo[o]} at output {o} of an axis of {n}")
        for i in {lo[o], hi[o]}:
            if not 2 * i - 1 <= o <= 2 * i + 2 and (
                    (lo[o] == i) * (1 - f[o]) + (hi[o] == i) * f[o]):
                raise ValueError(f"upsample2x: output {o} reaches input "
                                 f"{i} outside 2i-1 .. 2i+2 (n = {n})")


def _cdiv(a, b):
    return -(-a // b)


def _runs(total, run):
    return [(a, min(a + run, total)) for a in range(0, total, run)]


def fwd_spans(n, a, b):
    """Inputs [first, last] of an axis of n that outputs [a, b) read."""
    lo, hi, _ = axis_taps(n)
    return lo[a], hi[b - 1]


def bwd_spans(n, a, b):
    """Outputs [first, last] of an axis of n staged for inputs [a, b):
    2a - 1 .. 2(b - 1) + 2, clipped to the axis."""
    return max(2 * a - 1, 0), min(2 * b, 2 * n - 1)


def _span_max(spans, n, run, total):
    return max(e - s + 1 for s, e in (spans(n, a, b)
                                      for a, b in _runs(total, run)))


def _smem(nbuf, tables, rows, cols, C):
    """Dynamic shared memory of a block: nbuf mbarriers, `tables` 4-byte
    entries (both rounded up to 16 bytes), nbuf plane buffers of rows x
    cols voxels of C bf16 channels (csrc/upsample2x.cu: smem_bytes)."""
    return 16 * _cdiv(8 * nbuf, 16) + 16 * _cdiv(4 * tables, 16) \
        + nbuf * rows * cols * C * 2


def _plan(B, D, H, W, C, bwd, runs=None):
    """The tile plan of one launch (fwd_plan / bwd_plan)."""
    if C % 8 or min(D, H, W) < 1:
        raise ValueError(f"upsample2x: needs C % 8 == 0, got "
                         f"{(B, D, H, W, C)}")
    for n in (D, H, W):
        _check_axis(n)
    G = C // 8
    sx, nbuf, most = (BWD_SX, BWD_NBUF, BWD_THREADS) if bwd \
        else (FWD_SX, FWD_NBUF, FWD_THREADS)
    # the extents the tiles cover: inputs (adjoint) or outputs (forward)
    ext = (D, H, W) if bwd else (2 * D, 2 * H, 2 * W)
    spans = bwd_spans if bwd else fwd_spans
    # bytes written once: the forward's output, the adjoint's dx
    written = B * D * H * W * C * 2 * (1 if bwd else 8)

    def make(zr, yr, xr):
        nseg = _cdiv(xr, sx)
        threads = yr * nseg * G
        tiles = (_cdiv(ext[2], xr), _cdiv(ext[1], yr), _cdiv(ext[0], zr))
        rows = _span_max(spans, H, yr, ext[1])
        cols = _span_max(spans, W, xr, ext[2])
        planes = _span_max(spans, D, zr, ext[0])
        tables = 2 * planes + 4 * (yr + xr) if bwd else 2 * (zr + yr + xr)
        smem = _smem(nbuf, tables, rows, cols, C)
        blocks = B * tiles[0] * tiles[1] * tiles[2]
        # bytes staged over all tiles (halos counted as re-read)
        staged = B * sum((e - s + 1) for s, e in
                         (spans(D, a, b) for a, b in _runs(ext[0], zr))) \
            * sum(e - s + 1 for s, e in (spans(H, a, b)
                                         for a, b in _runs(ext[1], yr))) \
            * sum(e - s + 1 for s, e in (spans(W, a, b)
                                         for a, b in _runs(ext[2], xr))) \
            * C * 2
        return {"run": (zr, yr, xr), "nseg": nseg, "threads": threads,
                "tiles": tiles, "blocks": blocks, "rows": rows,
                "cols": cols, "planes": planes, "smem": smem,
                "staged_bytes": staged,
                "args": (zr, yr, xr, nseg, *tiles, rows, cols, planes,
                         threads, smem)}

    if runs is not None:
        return _check(make(*runs), B, D, H, W, C, bwd)
    best = None
    for yr in (1, 2, 4, 8, 16):
        for xr in sorted({min(ext[2], sx * k) for k in range(1, 11)}):
            for zr in sorted({min(ext[0], z) for z in
                              (2, 4, 8, 12, 16, 20, 24, 32, 40, 48, 80,
                               160)}):
                if yr > ext[1]:
                    continue
                p = make(zr, yr, xr)
                if not (64 <= p["threads"] <= most
                        and p["smem"] <= SMEM_BUDGET):
                    continue
                # bytes moved, stretched where the grid has fewer than
                # WAVES waves of two blocks per SM
                score = (p["staged_bytes"] + written) \
                    * max(1.0, WAVES * 2 * SMS / p["blocks"])
                key = (score, -p["threads"])
                if best is None or key < best[0]:
                    best = (key, p)
    if best is None:
        raise ValueError(f"upsample2x: no tile plan fits "
                         f"{(B, D, H, W, C)}")
    return _check(best[1], B, D, H, W, C, bwd)


def _check(p, B, D, H, W, C, bwd):
    """Raise unless plan `p` covers every output once, within its
    buffers and the card's limits."""
    zr, yr, xr = p["run"]
    ext = (D, H, W) if bwd else (2 * D, 2 * H, 2 * W)
    sx = BWD_SX if bwd else FWD_SX
    tx, ty, tz = p["tiles"]
    if tx * xr < ext[2] or ty * yr < ext[1] or tz * zr < ext[0] \
            or p["nseg"] * sx < xr:
        raise ValueError(f"upsample2x plan {p['args']} leaves outputs of "
                         f"{(B, D, H, W, C)} uncovered")
    most = BWD_THREADS if bwd else FWD_THREADS
    if p["threads"] != yr * p["nseg"] * (C // 8) or p["threads"] > most \
            or p["smem"] > 227 * 1024:
        raise ValueError(f"upsample2x plan {p['args']}: block too large")
    if not bwd and (xr % 2 or FWD_SX % 2):
        raise ValueError("upsample2x plan: x runs must pair outputs")
    return p


@functools.lru_cache(maxsize=None)
def fwd_plan(B, D, H, W, C, runs=None):
    """Geometry of one launch of csrc/upsample2x.cu's forward on a (B, D,
    H, W, C) input: runs (ZR output planes, YR output rows, XR output
    columns) per tile, FWD_SX outputs along x per thread (nseg segments),
    the tile grid (x fastest, then y, z, batch element), the staged
    input rows and columns per plane buffer (the most any tile needs)
    and the streamed planes per tile. `runs` fixes the tile instead of
    the search (which minimises the bytes staged and written, keeping
    WAVES waves of two blocks a SM). `args` is the vector the launcher runs."""
    return _plan(B, D, H, W, C, False, runs)


@functools.lru_cache(maxsize=None)
def bwd_plan(B, D, H, W, C, runs=None):
    """Geometry of one launch of csrc/upsample2x.cu's adjoint for a (B, D,
    H, W, C) result: as fwd_plan, with runs of input planes, rows and
    columns, BWD_SX inputs a thread along x, and the dy rows, columns and
    planes a tile stages (2i - 1 .. 2i + 2 around its inputs)."""
    return _plan(B, D, H, W, C, True, runs)


def _args(vals):
    return (ctypes.c_int64 * len(vals))(*vals)


def upsample2x(x):
    """Kernel wrapper: CUDA bf16 tensors launch csrc/upsample2x.cu
    (C % 8 == 0, else raise); CPU tensors take the plain version."""
    if not x.is_cuda:
        return upsample2x_plain(x)
    B, D, H, W, C = x.shape
    plan = fwd_plan(B, D, H, W, C)
    _build.check_operand(x, torch.bfloat16, "upsample2x x")
    y = torch.empty((B, 2 * D, 2 * H, 2 * W, C), dtype=x.dtype,
                    device=x.device)
    _build.launch("upsample2x_bf16", x.data_ptr(), y.data_ptr(),
                  B, D, H, W, C, _args(plan["args"]))
    upsample2x.launches += 1
    return y


upsample2x.launches = 0


@functools.lru_cache(maxsize=16)
def _up2_matrix(n):
    """(2n, n) f32 align-corners 2x interpolation matrix with the
    kernels' f32 arithmetic (axis_taps): weights (1 - f, f) on lo, hi."""
    lo, hi, f = (torch.tensor(v) for v in axis_taps(n))
    rows = torch.arange(2 * n)
    m = torch.zeros((2 * n, n), dtype=torch.float32)
    m.index_put_((rows, lo), 1.0 - f, accumulate=True)
    m.index_put_((rows, hi), f, accumulate=True)
    return m


def upsample2x_bwd_plain(dy):
    """Adjoint of upsample2x: (B, 2D, 2H, 2W, C) cotangent ->
    (B, D, H, W, C), three separable f32 matrix passes (the transposed
    interpolation matrices), returned in dy's dtype."""
    x = dy.float()
    for ax in (1, 2, 3):
        m = _up2_matrix(x.shape[ax] // 2).to(x.device)
        x = torch.movedim(torch.movedim(x, ax, -1) @ m, -1, ax)
    return x.to(dy.dtype).contiguous()


def upsample2x_bwd(dy):
    """Kernel wrapper of upsample2x_bwd_plain: CUDA bf16 tensors launch
    csrc/upsample2x.cu's adjoint (even sizes, C % 8 == 0, else raise);
    CPU tensors take the plain version."""
    if not dy.is_cuda:
        return upsample2x_bwd_plain(dy)
    B, D2, H2, W2, C = dy.shape
    if D2 % 2 or H2 % 2 or W2 % 2 or C % 8:
        raise ValueError(f"upsample2x_bwd: needs even D, H, W and "
                         f"C % 8 == 0, got {tuple(dy.shape)}")
    plan = bwd_plan(B, D2 // 2, H2 // 2, W2 // 2, C)
    _build.check_operand(dy, torch.bfloat16, "upsample2x_bwd dy")
    dx = torch.empty((B, D2 // 2, H2 // 2, W2 // 2, C), dtype=dy.dtype,
                     device=dy.device)
    _build.launch("upsample2x_bwd_bf16", dy.data_ptr(), dx.data_ptr(),
                  B, D2 // 2, H2 // 2, W2 // 2, C, _args(plan["args"]))
    upsample2x_bwd.launches += 1
    return dx


upsample2x_bwd.launches = 0


class Upsample2x(torch.autograd.Function):
    """upsample2x with its one-pass adjoint upsample2x_bwd."""

    @staticmethod
    def forward(ctx, x):
        return upsample2x(x)

    @staticmethod
    def backward(ctx, dy):
        return upsample2x_bwd(dy.contiguous())

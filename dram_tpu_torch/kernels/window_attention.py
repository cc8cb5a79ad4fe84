"""Stencil attention of the PCM refinement (merge type
'scaled_dot_product_relu') and its gradient, on any stencil and widths.

Port of dram_tpu/core/pallas/window_attention.py:stencil_attention, the
jax.custom_vjp that dram_tpu/models/pcm.py calls on its use_pallas
branch: the forward (_fwd_kernel) and the two passes of its backward
(_vjp_bwd: the per-voxel statistics _scal_kernel, then the gathered
gradients _bwd_kernel), bound together by StencilAttentionFunction. The
plain versions are the roll+mask formulation of dram_tpu/models/pcm.py.

Two kernel families, chosen by the operands (never by a failure):

- the plane ring (csrc/stencil_attention.cu) takes the shipped stencil
  (KERNEL_OFFSETS: k = 3, connectivity 2, no self loop) with F = G = 8;
- the generic kernels (csrc/stencil_attention_generic.cu, forward and
  statistics pass; csrc/stencil_attention_generic_bwd.cu, gradient pass)
  take every other stencil of up to GENERIC_MAX_K offsets within
  GENERIC_MAX_HALO of the centre and widths 1..GENERIC_MAX_WIDTH.

A CUDA tensor that neither takes raises; CPU tensors take the plain
versions. `stencil_attention`, `stencil_attention_scal` and
`stencil_attention_bwd` dispatch and count the plane ring's launches;
`stencil_attention_generic`, `stencil_attention_scal_generic` and
`stencil_attention_bwd_generic` launch (and count) the generic kernels.

The launch geometry of the plane-ring forward and gradient pass is
decided here (fwd_plan, bwd_plan; for the generic kernels
generic_fwd_plan, generic_scal_plan, generic_bwd_plan): a block owns a
tile of (batch element, run of z-planes, run of rows, run of columns)
and streams it
along z through a ring of shared-memory plane buffers, each holding the
tile's rows and columns with a halo (+-1; the generic kernels' +-h, h
the stencil's largest offset component). The plans raise where a tile
plan would leave a voxel uncovered; the C launchers run the `args`
vector they are handed and refuse one whose buffers or coverage differ
from the kernel's.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

# threads a block may have (csrc/stencil_attention.cu: FWD_THREADS,
# BWD_THREADS: two for each voxel of the tile's plane, in warps that share
# 16 voxels (forward) or warp pairs that share 32 (gradient pass), and a
# producer warp)
FWD_THREADS, BWD_THREADS = 288, 288
# bytes of one staged voxel: phi, g, theta (forward); phi, g, theta, ybar
# and the four statistics (gradient pass)
FWD_VOXEL, BWD_VOXEL = 3 * 32, 4 * 32 + 16
# the tile the plans take where the grid allows: (planes, rows, columns)
# per tile, forward and gradient pass. On the card (NVIDIA H100 80GB
# HBM3, 700 W; tools/attention_variants.py) 8 rows of 16 columns and 16
# planes a run were within a few percent of the best of 24 tiles of 64 to
# 128 voxels at every attention launch of the flagship: their buffers
# leave room for three forward blocks (two gradient blocks) on an SM.
# Deeper rings than NBUF gained nothing.
FWD_RUNS = BWD_RUNS = (16, 8, 16)
# plane buffers: three read (z - 1, z, z + 1) while a fourth loads
NBUF, MAX_NBUF = 4, 8
# shared memory a block may have; the ring's mbarriers
SMEM_BLOCK, BAR_BYTES = 227 * 1024, 128


@functools.lru_cache(maxsize=64)
def stencil_offsets(k_size=3, connectivity=2, self_loop=False):
    """Neighbour offsets of the reference's zoomed binary structure:
    dram_tpu/models/pcm.py:stencil_offsets without scipy. The voxels
    within L1 distance `connectivity` of the centre of a 3^3 cube
    (scipy's generate_binary_structure(3, connectivity)), zoomed to
    k_size^3 by nearest neighbour as scipy's ndimage.zoom(order=0) does
    (output voxel o reads input coordinate o (3 - 1) / (k_size - 1),
    rounded half up), minus the centre unless `self_loop`, in
    lexicographic (z, y, x) order.

    For k_size 5 the rounding makes connectivity 1 and 2 asymmetric: some
    offset o is in the stencil while -o is not."""
    k = int(k_size)
    if k < 1:
        raise ValueError(f"k_size={k_size}: needs k_size >= 1")
    c = max(int(connectivity), 1)
    i = np.abs(np.arange(3) - 1)
    base = i[:, None, None] + i[None, :, None] + i[None, None, :] <= c
    if k != 3:
        src = np.floor(np.arange(k) * (2.0 / max(k - 1, 1)) + 0.5)
        src = np.clip(src.astype(np.int64), 0, 2)
        base = base[np.ix_(src, src, src)]
    offs = np.argwhere(base) - k // 2
    if not self_loop:
        offs = offs[~np.all(offs == 0, axis=1)]
    return tuple(map(tuple, offs.tolist()))


# the offsets csrc/stencil_attention.cu enumerates
KERNEL_OFFSETS = stencil_offsets(3, 2, False)
# what csrc/stencil_attention_generic.cu takes: offsets, their largest
# |component|, widths
GENERIC_MAX_K, GENERIC_MAX_HALO, GENERIC_MAX_WIDTH = 343, 3, 64


def ring_takes(offsets, F, G):
    """The plane-ring kernels take these operands: the shipped stencil
    with F = G = 8."""
    return tuple(map(tuple, offsets)) == KERNEL_OFFSETS and F == G == 8


def generic_takes(offsets, F, G):
    """The generic kernels take these operands: 1..GENERIC_MAX_K offsets
    within GENERIC_MAX_HALO of the centre, widths 1..GENERIC_MAX_WIDTH."""
    return (1 <= len(offsets) <= GENERIC_MAX_K
            and all(abs(a) <= GENERIC_MAX_HALO for o in offsets for a in o)
            and 1 <= F <= GENERIC_MAX_WIDTH and 1 <= G <= GENERIC_MAX_WIDTH)


def valid_masks(spatial, offsets, device=None, z0=0, z_extent=None):
    """(D, H, W, K) bool: neighbour i + offset lies inside the volume
    (dram_tpu/models/pcm.py:_valid_masks). A block of a larger volume
    (the sharded PCM) passes `z0`, the global index of its z = 0, and
    `z_extent`, the volume's depth: the volume's faces, not the block's,
    decide."""
    D, H, W = spatial
    if z_extent is None:
        z_extent = D
    iz = torch.arange(D, device=device)[:, None, None] + int(z0)
    iy = torch.arange(H, device=device)[None, :, None]
    ix = torch.arange(W, device=device)[None, None, :]
    masks = [(iz + dz >= 0) & (iz + dz < z_extent) & (iy + dy >= 0)
             & (iy + dy < H)
             & (ix + dx >= 0) & (ix + dx < W) for dz, dy, dx in offsets]
    return torch.stack(masks, dim=-1)


def _shift(x, off):
    """x[i] <- x[i + off] over the spatial axes of (B, D, H, W, C)."""
    return torch.roll(x, shifts=(-off[0], -off[1], -off[2]), dims=(1, 2, 3))


def _real(t):
    """f32, or float64 where the caller computes in float64 (the tests'
    reference precision)."""
    return t if t.dtype == torch.float64 else t.float()


def _edge_logits(theta, phi, offsets):
    """Per offset k the masked logit relu(theta_i . phi_{i+o}) r_i (-inf
    where i + o lies outside), the raw dot and r = 1/sqrt(max(deg, 1)):
    ((B, D, H, W, K), (B, D, H, W, K), (D, H, W, 1))."""
    valid = valid_masks(theta.shape[1:4], offsets, theta.device)
    r = torch.rsqrt(torch.clamp(valid.sum(-1, keepdim=True).to(theta.dtype),
                                min=1.0))
    dots = torch.stack([(theta * _shift(phi, off)).sum(-1)
                        for off in offsets], dim=-1)
    logits = torch.where(valid, torch.relu(dots) * r,
                         torch.tensor(float("-inf"), device=theta.device))
    return logits, dots, r


def stencil_attention_plain(theta, phi, g, offsets=KERNEL_OFFSETS):
    """theta, phi: (B, D, H, W, F); g: (B, D, H, W, G) -> (B, D, H, W, G).

    Per voxel, a softmax over the valid stencil neighbours j of
    relu(theta_i . phi_j) / sqrt(deg_i), aggregating g_j, in f32."""
    theta, phi, g = (_real(t) for t in (theta, phi, g))
    logits, _, _ = _edge_logits(theta, phi, offsets)
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(logits - m)
    w = e / torch.clamp(e.sum(-1, keepdim=True), min=1e-12)
    out = torch.zeros_like(g)
    for k, off in enumerate(offsets):
        out = out + w[..., k:k + 1] * _shift(g, off)
    return out


def _check_ring(name, offsets, *ts):
    """Raise unless the plane-ring kernels take these operands: the
    18-offset stencil, f32 (B, D, H, W, 8) tensors on one grid,
    contiguous."""
    if tuple(map(tuple, offsets)) != KERNEL_OFFSETS:
        raise ValueError(f"{name}: the plane-ring kernel implements the "
                         "k=3, connectivity-2, no-self-loop stencil only")
    shape = tuple(ts[0].shape)
    if len(shape) != 5 or shape[-1] != 8 \
            or any(tuple(t.shape) != shape for t in ts):
        raise ValueError(f"{name}: needs F = G = 8 on one grid, got "
                         f"{[tuple(t.shape) for t in ts]}")
    for k, t in enumerate(ts):
        _build.check_operand(t, torch.float32, f"{name} operand {k}")
    return shape[:4]


def _check_generic(name, offsets, fw, gw):
    """Raise unless the generic kernels take these operands: `fw` the
    F-wide tensors (theta, phi, ...), `gw` the G-wide ones (g, ybar,
    ...), f32 (B, D, H, W, width) on one grid, contiguous, and a stencil
    and widths of generic_takes. Returns ((B, D, H, W), F, G)."""
    grid = tuple(fw[0].shape[:4])
    F, G = fw[0].shape[-1], gw[0].shape[-1]
    if fw[0].dim() != 5 or any(
            t.dim() != 5 or tuple(t.shape[:4]) != grid for t in fw + gw) \
            or any(t.shape[-1] != F for t in fw) \
            or any(t.shape[-1] != G for t in gw):
        raise ValueError(f"{name}: needs (B, D, H, W, F) and (B, D, H, W, "
                         f"G) on one grid, got "
                         f"{[tuple(t.shape) for t in fw + gw]}")
    if not generic_takes(offsets, F, G):
        raise ValueError(
            f"{name}: the generic kernel takes 1..{GENERIC_MAX_K} offsets "
            f"within {GENERIC_MAX_HALO} of the centre and widths "
            f"1..{GENERIC_MAX_WIDTH}, got {len(offsets)} offsets, F = {F}, "
            f"G = {G}")
    for k, t in enumerate(fw + gw):
        _build.check_operand(t, torch.float32, f"{name} operand {k}")
    return grid, F, G


def _offsets_arg(offsets):
    """The offsets as the C launchers take them: (K * 3) int32, host."""
    flat = [a for o in offsets for a in o]
    return (ctypes.c_int32 * len(flat))(*flat), len(offsets)


def _cdiv(a, b):
    return -(-a // b)


def _smem(nbuf, rows, cols, voxel):
    """Dynamic shared memory of a block: the mbarriers' BAR_BYTES, then
    nbuf buffers of rows x cols staged voxels (csrc/stencil_attention.cu:
    smem_bytes)."""
    return BAR_BYTES + nbuf * rows * cols * voxel


def _threads(yr, xr):
    """Threads of a block whose tile plane has yr x xr voxels: two a
    voxel, in whole warp pairs of 32 voxels, and the producer warp."""
    return 64 * _cdiv(yr * xr, 32) + 32


def _plan(B, D, H, W, bwd, runs=None, nbuf=None):
    """The tile plan of one launch (fwd_plan / bwd_plan)."""
    if min(D, H, W) < 1 or B < 0:
        raise ValueError(f"stencil_attention plan: empty grid "
                         f"{(B, D, H, W)}")
    zr, yr, xr = runs or tuple(min(r, n) for r, n in zip(
        BWD_RUNS if bwd else FWD_RUNS, (D, H, W)))
    nbuf = nbuf or NBUF
    tiles = (_cdiv(W, xr), _cdiv(H, yr), _cdiv(D, zr))
    rows, cols = min(yr + 2, H), min(xr + 2, W)
    threads = _threads(yr, xr)
    smem = _smem(nbuf, rows, cols, BWD_VOXEL if bwd else FWD_VOXEL)
    p = {"run": (zr, yr, xr), "tiles": tiles,
         "blocks": B * tiles[0] * tiles[1] * tiles[2], "rows": rows,
         "cols": cols, "nbuf": nbuf, "threads": threads, "smem": smem,
         "args": (zr, yr, xr, *tiles, rows, cols, nbuf, threads, smem)}
    return _check(p, B, D, H, W, bwd)


def _check(p, B, D, H, W, bwd):
    """Raise unless plan `p` covers every voxel once, within its buffers
    and the card's limits."""
    zr, yr, xr = p["run"]
    tx, ty, tz = p["tiles"]
    if tx * xr < W or ty * yr < H or tz * zr < D:
        raise ValueError(f"stencil_attention plan {p['args']} leaves voxels "
                         f"of {(B, D, H, W)} uncovered")
    voxel, most = (BWD_VOXEL, BWD_THREADS) if bwd \
        else (FWD_VOXEL, FWD_THREADS)
    if p["rows"] != min(yr + 2, H) or p["cols"] != min(xr + 2, W) \
            or not 3 <= p["nbuf"] <= MAX_NBUF \
            or p["smem"] != _smem(p["nbuf"], p["rows"], p["cols"], voxel):
        raise ValueError(f"stencil_attention plan {p['args']}: buffers "
                         "differ from the kernel's")
    if p["threads"] != _threads(yr, xr) or p["threads"] > most \
            or p["smem"] > SMEM_BLOCK:
        raise ValueError(f"stencil_attention plan {p['args']}: block too "
                         "large")
    return p


@functools.lru_cache(maxsize=None)
def fwd_plan(B, D, H, W, runs=None, nbuf=None):
    """Geometry of one launch of csrc/stencil_attention.cu's forward on a
    (B, D, H, W) grid: runs (ZR planes, YR rows, XR columns) per tile
    (FWD_RUNS, clipped to the grid, unless `runs` is given), the tile grid
    (x fastest, then y, z, batch element), the staged rows and columns per
    plane buffer (the run and its +-1 halo, clipped), the ring's nbuf
    buffers (NBUF unless given) and the threads: two a voxel of the
    tile's plane, lanes l and l + 16 of a warp, each over nine of the
    offsets, and the producer warp. `args` is the vector the launcher
    runs."""
    return _plan(B, D, H, W, False, runs, nbuf)


@functools.lru_cache(maxsize=None)
def bwd_plan(B, D, H, W, runs=None, nbuf=None):
    """Geometry of one launch of csrc/stencil_attention.cu's gradient pass
    on a (B, D, H, W) grid: as fwd_plan, with BWD_RUNS, the gradient
    pass's staged voxel (phi, g, theta, ybar and the statistics, 144
    bytes) and two threads a voxel in warps of one side each (+o, -o) that
    share 32 voxels."""
    return _plan(B, D, H, W, True, runs, nbuf)


# --- the generic kernels' plane ring (csrc/stencil_generic_ring.cuh) -----------

# plane buffers a generic ring may have, their mbarriers' bytes, threads a
# block may have (the kernels' launch bound)
GENERIC_MAX_NBUF, GENERIC_BAR_BYTES, GENERIC_MAX_THREADS = 16, 256, 512
# the tile (planes, rows, columns) and the sets of compute warps that take
# the tile's planes in turn, by pass (fwd; the statistics pass, scal; the
# gradient pass's +o and -o sides), where the grid and shared memory
# allow. On the card (NVIDIA H100 80GB HBM3, 700 W;
# tools/generic_attention_variants.py) these were the fastest of 8 tiles
# of 32 to 128 voxels a plane and 2 to 8 sets at variant A's step shape
# (10 x 64^3, 98 offsets, F = 16, G = 4): the forward's within 3% of the
# next three, and the best at batch 5 too
GENERIC_RUNS = {"fwd": (16, 8, 8), "scal": (16, 8, 8), "plus": (32, 8, 16),
                "minus": (32, 8, 16)}
GENERIC_SETS = {"fwd": 4, "scal": 4, "plus": 3, "minus": 3}


def generic_halo(offsets):
    """The largest |component| of the offsets: the generic rings' halo."""
    return max(abs(a) for o in offsets for a in o)


def generic_class(F, G):
    """(lanes a voxel, float4 chunks of an F-wide row a lane holds, of a
    G-wide one): the kernels' width class (csrc/stencil_generic_ring.cuh:
    class_of)."""
    qf, qg = _cdiv(F, 4), _cdiv(G, 4)
    if qf <= 4 and qg <= 1:
        return 1, 4, 1
    if qf <= 4 and qg <= 4:
        return 1, 4, 4
    return 4, 4, 4


def generic_voxel(kind, F, G):
    """Floats of a staged voxel: phi and g (fwd, scal, plus), theta, ybar
    and the statistics (minus), each row padded to a multiple of 4 (the
    wrappers pad the channels)."""
    return 4 * _cdiv(F, 4) + 4 * _cdiv(G, 4) + (4 if kind == "minus" else 0)


def _generic_one(kind, B, D, H, W, F, G, h, runs, sets, nbuf, reload):
    zr, yr, xr = (min(r, n) for r, n in zip(runs, (D, H, W)))
    lanes = generic_class(F, G)[0]
    tiles = (_cdiv(W, xr), _cdiv(H, yr), _cdiv(D, zr))
    rows, cols = min(yr + 2 * h, H), min(xr + 2 * h, W)
    threads = 32 * (sets * _cdiv(yr * xr * lanes, 32) + 1)
    smem = GENERIC_BAR_BYTES + nbuf * rows * cols * generic_voxel(
        kind, F, G) * 4
    p = {"kind": kind, "run": (zr, yr, xr), "tiles": tiles,
         "blocks": B * tiles[0] * tiles[1] * tiles[2], "rows": rows,
         "cols": cols, "nbuf": nbuf, "sets": sets, "reload": reload,
         "threads": threads, "smem": smem, "halo": h, "lanes": lanes,
         "args": (zr, yr, xr, *tiles, rows, cols, nbuf, sets, reload,
                  threads, smem, h, lanes)}
    return p


def _generic_check(p, B, D, H, W, F, G):
    """Raise unless plan `p` covers every voxel once, within its buffers
    and the card's limits (csrc/stencil_generic_ring.cuh:plan_ok)."""
    zr, yr, xr = p["run"]
    tx, ty, tz = p["tiles"]
    h, sets, nbuf = p["halo"], p["sets"], p["nbuf"]
    if min(zr, yr, xr) < 1 or tx * xr < W or ty * yr < H or tz * zr < D \
            or (tx - 1) * xr >= W or (ty - 1) * yr >= H \
            or (tz - 1) * zr >= D:
        raise ValueError(f"generic attention plan {p['args']} does not "
                         f"cover {(B, D, H, W)} once")
    if p["rows"] != min(yr + 2 * h, H) or p["cols"] != min(xr + 2 * h, W) \
            or p["lanes"] != generic_class(F, G)[0] \
            or not (p["reload"] == 1 and sets == 1
                    and 2 <= nbuf <= GENERIC_MAX_NBUF
                    or p["reload"] == 0 and sets >= 1
                    and 2 * h + sets + 1 <= nbuf <= GENERIC_MAX_NBUF) \
            or p["smem"] != GENERIC_BAR_BYTES + nbuf * p["rows"] * p["cols"] \
            * generic_voxel(p["kind"], F, G) * 4:
        raise ValueError(f"generic attention plan {p['args']}: buffers "
                         "differ from the kernel's")
    if p["threads"] != 32 * (sets * _cdiv(yr * xr * p["lanes"], 32) + 1) \
            or p["threads"] > GENERIC_MAX_THREADS or p["smem"] > SMEM_BLOCK:
        raise ValueError(f"generic attention plan {p['args']}: block too "
                         "large")
    return p


def _generic_shrink(yr, xr):
    """Tiles from (yr, xr) down: rows halved first, then columns."""
    out = [(yr, xr)]
    while yr > 1:
        yr = _cdiv(yr, 2)
        out.append((yr, xr))
    while xr > 1:
        xr = _cdiv(xr, 2)
        out.append((yr, xr))
    return out


def _generic_plan(kind, B, D, H, W, F, G, h, runs, sets, nbuf, reload):
    if min(D, H, W) < 1 or B < 0:
        raise ValueError(f"generic attention plan: empty grid "
                         f"{(B, D, H, W)}")
    if not 0 <= h <= GENERIC_MAX_HALO:
        raise ValueError(f"generic attention plan: halo {h}")
    if runs is not None:
        # a given tile (the sweep's): the whole ring unless `reload`
        reload = int(bool(reload))
        sets = 1 if reload else (sets or GENERIC_SETS[kind])
        nbuf = nbuf or (2 if reload else 2 * h + sets + 1)
        return _generic_check(_generic_one(kind, B, D, H, W, F, G, h, runs,
                                           sets, nbuf, reload),
                              B, D, H, W, F, G)
    zr, yr, xr = (min(r, n) for r, n in zip(GENERIC_RUNS[kind], (D, H, W)))
    lanes = generic_class(F, G)[0]
    tiles = _generic_shrink(yr, xr)
    # the whole ring with at least one warp of voxels a tile plane, sets
    # from the preferred down to one; else the reload ring
    for y, x in tiles:
        if y * x < min(32 // lanes, H * W):
            break
        for s in range(GENERIC_SETS[kind], 0, -1):
            p = _generic_one(kind, B, D, H, W, F, G, h, (zr, y, x), s,
                             2 * h + s + 1, 0)
            if p["smem"] <= SMEM_BLOCK and p["threads"] <= \
                    GENERIC_MAX_THREADS:
                return _generic_check(p, B, D, H, W, F, G)
    for y, x in tiles:
        p = _generic_one(kind, B, D, H, W, F, G, h, (zr, y, x), 1, 2, 1)
        if p["smem"] <= SMEM_BLOCK and p["threads"] <= GENERIC_MAX_THREADS:
            return _generic_check(p, B, D, H, W, F, G)
    raise ValueError(f"generic attention plan: no tile of {(D, H, W)} "
                     f"fits F = {F}, G = {G}, halo {h}")


@functools.lru_cache(maxsize=None)
def generic_fwd_plan(B, D, H, W, F, G, h, runs=None, sets=None, nbuf=None,
                     reload=None):
    """Geometry of one launch of csrc/stencil_attention_generic.cu's
    forward on a (B, D, H, W) grid at widths F, G and halo h: a block
    owns a tile of GENERIC_RUNS["fwd"] (clipped to the grid) and stages
    phi and g of its rows and columns +-h, plane by plane, into a ring;
    the whole ring (2h + sets + 1 buffers, GENERIC_SETS sets of compute
    warps) where shared memory holds it for a tile of one warp's voxels
    or more, the tile's rows then columns halved until it does; else the
    reload ring (two buffers, one set). `runs` (with `sets`, `nbuf`,
    `reload`) gives the tile instead. `args` is the vector the launcher
    runs."""
    return _generic_plan("fwd", B, D, H, W, F, G, h, runs, sets, nbuf,
                         reload)


@functools.lru_cache(maxsize=None)
def generic_scal_plan(B, D, H, W, F, G, h, runs=None, sets=None, nbuf=None,
                      reload=None):
    """Geometry of one launch of csrc/stencil_attention_generic.cu's
    statistics pass: phi and g staged as the forward stages them, chosen
    as generic_fwd_plan chooses with GENERIC_RUNS["scal"] and
    GENERIC_SETS["scal"]."""
    return _generic_plan("scal", B, D, H, W, F, G, h, runs, sets, nbuf,
                         reload)


@functools.lru_cache(maxsize=None)
def generic_bwd_plan(B, D, H, W, F, G, h, runs=None, sets=None, nbuf=None,
                     reload=None):
    """Geometry of one launch of csrc/stencil_attention_generic_bwd.cu's
    gradient pass: the +o side's plan ("plus": phi and g staged) and the
    -o side's ("minus": theta, ybar and the statistics staged), each
    chosen as generic_fwd_plan chooses (GENERIC_RUNS / GENERIC_SETS of
    its side); `args` is the +o side's vector, then the -o side's."""
    plus, minus = (_generic_plan(k, B, D, H, W, F, G, h, runs, sets, nbuf,
                                 reload) for k in ("plus", "minus"))
    return {"plus": plus, "minus": minus,
            "args": plus["args"] + minus["args"]}


def _args(vals):
    return (ctypes.c_int64 * len(vals))(*vals)


def _forward(theta, phi, g, offsets):
    """The forward: CUDA tensors launch the plane ring where it takes
    them, else the generic kernel (which raises on what it does not
    take); CPU tensors take the plain version."""
    if not theta.is_cuda:
        return stencil_attention_plain(theta, phi, g, offsets)
    if not ring_takes(offsets, theta.shape[-1], g.shape[-1]):
        return stencil_attention_generic(theta, phi, g, offsets)
    B, D, H, W = _check_ring("stencil_attention", offsets, theta, phi, g)
    out = torch.empty_like(g)
    if out.numel() == 0:
        return out
    plan = fwd_plan(B, D, H, W)
    _build.launch("stencil_attention_f32", theta.data_ptr(), phi.data_ptr(),
                  g.data_ptr(), out.data_ptr(), B, D, H, W,
                  _args(plan["args"]))
    stencil_attention.launches += 1
    return out


def _pad4(t):
    """t (..., C) with its channels zero-padded to a multiple of 4: the
    generic plane rings stage 16-byte rows (a zero channel adds nothing
    to a dot, a sum or a gradient); t itself where C is one already."""
    c = t.shape[-1]
    return t if c % 4 == 0 else \
        torch.nn.functional.pad(t, (0, -c % 4)).contiguous()


def _unpad(t, c):
    """The first c channels of a padded result, contiguous."""
    return t if t.shape[-1] == c else t[..., :c].contiguous()


def stencil_attention_generic(theta, phi, g, offsets):
    """Kernel wrapper of stencil_attention_plain on any stencil and widths
    of generic_takes: CUDA tensors launch csrc/stencil_attention_generic.cu's
    plane-ring forward on generic_fwd_plan (else raise), widths that are
    not a multiple of 4 zero-padded to one; CPU tensors take the plain
    version. Not differentiable by itself: StencilAttentionFunction calls
    it."""
    if not theta.is_cuda:
        return stencil_attention_plain(theta, phi, g, offsets)
    (B, D, H, W), F, G = _check_generic("stencil_attention_generic",
                                        offsets, (theta, phi), (g,))
    if g.numel() == 0:
        return torch.empty_like(g)
    plan = generic_fwd_plan(B, D, H, W, F, G, generic_halo(offsets))
    theta, phi, g = (_pad4(t) for t in (theta, phi, g))
    out = torch.empty_like(g)
    offs, K = _offsets_arg(offsets)
    _build.launch("stencil_attention_generic_f32", theta.data_ptr(),
                  phi.data_ptr(), g.data_ptr(), out.data_ptr(), B, D, H, W,
                  theta.shape[-1], g.shape[-1], offs, K, _args(plan["args"]))
    stencil_attention_generic.launches += 1
    return _unpad(out, G)


stencil_attention_generic.launches = 0


# --- backward -------------------------------------------------------------------


def stencil_attention_scal_plain(theta, phi, g, ybar,
                                 offsets=KERNEL_OFFSETS):
    """Per-voxel statistics of the backward, (B, D, H, W, 4) f32 =
    [r, m, denom, c]: r = 1/sqrt(max(deg, 1)), m = max(0, max_j s_ij) of
    the logits s_ij = relu(theta_i . phi_j) r over the valid neighbours,
    denom = sum_j exp(s_ij - m), c = sum_j a_ij (ybar_i . g_j) with the
    softmax weights a_ij."""
    theta, phi, g, ybar = (_real(t) for t in (theta, phi, g, ybar))
    logits, _, r = _edge_logits(theta, phi, offsets)
    m = torch.clamp(logits.amax(dim=-1), min=0.0)
    e = torch.exp(logits - m[..., None])
    denom = e.sum(-1)
    u = torch.stack([(ybar * _shift(g, off)).sum(-1) for off in offsets],
                    dim=-1)
    c = (e * u).sum(-1) / torch.clamp(denom, min=1e-12)
    return torch.stack([r[..., 0].expand_as(m), m, denom, c], dim=-1)


def stencil_attention_scal(theta, phi, g, ybar, offsets=KERNEL_OFFSETS):
    """Kernel wrapper of stencil_attention_scal_plain: CUDA tensors launch
    csrc/stencil_attention.cu's statistics pass where the plane ring
    takes them (f32, F = G = 8, the 18-offset stencil), else
    stencil_attention_scal_generic; CPU tensors take the plain
    version."""
    if not theta.is_cuda:
        return stencil_attention_scal_plain(theta, phi, g, ybar, offsets)
    if not ring_takes(offsets, theta.shape[-1], g.shape[-1]):
        return stencil_attention_scal_generic(theta, phi, g, ybar, offsets)
    B, D, H, W = _check_ring("stencil_attention_scal", offsets, theta, phi,
                             g, ybar)
    scal = torch.empty((B, D, H, W, 4), dtype=torch.float32,
                       device=theta.device)
    _build.launch("stencil_attention_scal_f32", theta.data_ptr(),
                  phi.data_ptr(), g.data_ptr(), ybar.data_ptr(),
                  scal.data_ptr(), B, D, H, W)
    stencil_attention_scal.launches += 1
    return scal


def stencil_attention_scal_generic(theta, phi, g, ybar, offsets):
    """Kernel wrapper of stencil_attention_scal_plain on any stencil and
    widths of generic_takes: CUDA tensors launch
    csrc/stencil_attention_generic.cu's plane-ring statistics pass on
    generic_scal_plan (else raise), widths that are not a multiple of 4
    zero-padded to one (a zero channel changes neither a logit nor u);
    CPU tensors take the plain version."""
    if not theta.is_cuda:
        return stencil_attention_scal_plain(theta, phi, g, ybar, offsets)
    (B, D, H, W), F, G = _check_generic(
        "stencil_attention_scal_generic", offsets, (theta, phi), (g, ybar))
    scal = torch.empty((B, D, H, W, 4), dtype=torch.float32,
                       device=theta.device)
    if scal.numel() == 0:
        return scal
    plan = generic_scal_plan(B, D, H, W, F, G, generic_halo(offsets))
    theta, phi, g, ybar = (_pad4(t) for t in (theta, phi, g, ybar))
    offs, K = _offsets_arg(offsets)
    _build.launch("stencil_attention_scal_generic_f32", theta.data_ptr(),
                  phi.data_ptr(), g.data_ptr(), ybar.data_ptr(),
                  scal.data_ptr(), B, D, H, W, theta.shape[-1], g.shape[-1],
                  offs, K, _args(plan["args"]))
    stencil_attention_scal_generic.launches += 1
    return scal


stencil_attention_scal_generic.launches = 0
stencil_attention_scal.launches = 0


def stencil_attention_bwd_plain(theta, phi, g, ybar, scal,
                                offsets=KERNEL_OFFSETS):
    """(dtheta, dphi, dg) of the stencil attention from its inputs, the
    output cotangent ybar and the statistics `scal` (r, m, denom, c):

        dtheta_j = sum_o ds_o(j) phi_{j+o}
        dphi_j   = sum_o ds_o(j-o) theta_{j-o}
        dg_j     = sum_o a_o(j-o) ybar_{j-o}

    with a_o(i) = exp(s_o(i) - m_i) / denom_i over valid i + o,
    u_o(i) = ybar_i . g_{i+o} and ds_o(i) = a_o(i) (u_o(i) - c_i) r_i
    [theta_i . phi_{i+o} > 0]. The -o terms are the +o terms of i = j - o
    rolled to j, masked by the validity of i."""
    theta, phi, g, ybar, scal = (_real(t)
                                 for t in (theta, phi, g, ybar, scal))
    r, m, den, c = (scal[..., k:k + 1] for k in range(4))
    den = torch.clamp(den, min=1e-12)
    logits, dots, _ = _edge_logits(theta, phi, offsets)
    a = torch.exp(logits - m) / den
    back = valid_masks(theta.shape[1:4], [(-dz, -dy, -dx) for dz, dy, dx
                                          in offsets], theta.device)
    dtheta, dphi, dg = (torch.zeros_like(t) for t in (theta, phi, g))
    for k, off in enumerate(offsets):
        ak = a[..., k:k + 1]
        u = (ybar * _shift(g, off)).sum(-1, keepdim=True)
        ds = torch.where(dots[..., k:k + 1] > 0, ak * (u - c) * r, 0.0)
        dtheta = dtheta + ds * _shift(phi, off)
        neg = (-off[0], -off[1], -off[2])
        vi = back[..., k:k + 1]
        dphi = dphi + torch.where(vi, _shift(ds * theta, neg), 0.0)
        dg = dg + torch.where(vi, _shift(ak * ybar, neg), 0.0)
    return dtheta, dphi, dg


def stencil_attention_bwd(theta, phi, g, ybar, scal, offsets=KERNEL_OFFSETS):
    """Kernel wrapper of stencil_attention_bwd_plain: CUDA tensors launch
    csrc/stencil_attention.cu's gradient pass where the plane ring takes
    them (f32, F = G = 8, the 18-offset stencil), else
    stencil_attention_bwd_generic; CPU tensors take the plain version."""
    if not theta.is_cuda:
        return stencil_attention_bwd_plain(theta, phi, g, ybar, scal,
                                           offsets)
    if not ring_takes(offsets, theta.shape[-1], g.shape[-1]):
        return stencil_attention_bwd_generic(theta, phi, g, ybar, scal,
                                             offsets)
    B, D, H, W = _check_ring("stencil_attention_bwd", offsets, theta, phi,
                             g, ybar)
    _check_scal("stencil_attention_bwd", scal, (B, D, H, W))
    dtheta, dphi, dg = (torch.empty_like(t) for t in (theta, phi, g))
    if dtheta.numel() == 0:
        return dtheta, dphi, dg
    plan = bwd_plan(B, D, H, W)
    _build.launch("stencil_attention_bwd_f32", theta.data_ptr(),
                  phi.data_ptr(), g.data_ptr(), ybar.data_ptr(),
                  scal.data_ptr(), dtheta.data_ptr(), dphi.data_ptr(),
                  dg.data_ptr(), B, D, H, W, _args(plan["args"]))
    stencil_attention_bwd.launches += 1
    return dtheta, dphi, dg


def _check_scal(name, scal, grid):
    if tuple(scal.shape) != (*grid, 4):
        raise ValueError(f"{name}: scal {tuple(scal.shape)} does not fit "
                         f"{grid}")
    _build.check_operand(scal, torch.float32, f"{name} scal")


def stencil_attention_bwd_generic(theta, phi, g, ybar, scal, offsets):
    """Kernel wrapper of stencil_attention_bwd_plain on any stencil and
    widths of generic_takes: CUDA tensors launch
    csrc/stencil_attention_generic_bwd.cu's two plane rings on
    generic_bwd_plan (else raise), the -o side's dphi and dg gathered over
    i = j - o, widths that are not a multiple of 4 zero-padded to one;
    CPU tensors take the plain version."""
    if not theta.is_cuda:
        return stencil_attention_bwd_plain(theta, phi, g, ybar, scal,
                                           offsets)
    (B, D, H, W), F, G = _check_generic(
        "stencil_attention_bwd_generic", offsets, (theta, phi), (g, ybar))
    _check_scal("stencil_attention_bwd_generic", scal, (B, D, H, W))
    if theta.numel() == 0:
        return tuple(torch.empty_like(t) for t in (theta, phi, g))
    plan = generic_bwd_plan(B, D, H, W, F, G, generic_halo(offsets))
    theta, phi, g, ybar = (_pad4(t) for t in (theta, phi, g, ybar))
    dtheta, dphi, dg = (torch.empty_like(t) for t in (theta, phi, g))
    offs, K = _offsets_arg(offsets)
    _build.launch("stencil_attention_bwd_generic_f32", theta.data_ptr(),
                  phi.data_ptr(), g.data_ptr(), ybar.data_ptr(),
                  scal.data_ptr(), dtheta.data_ptr(), dphi.data_ptr(),
                  dg.data_ptr(), B, D, H, W, theta.shape[-1], g.shape[-1],
                  offs, K, _args(plan["args"]))
    stencil_attention_bwd_generic.launches += 1
    return _unpad(dtheta, F), _unpad(dphi, F), _unpad(dg, G)


stencil_attention_bwd_generic.launches = 0
stencil_attention_bwd.launches = 0


class StencilAttentionFunction(torch.autograd.Function):
    """The stencil attention with its two-pass gradient: the custom VJP of
    dram_tpu's stencil_attention (_vjp_fwd saves theta, phi and g;
    _vjp_bwd runs the statistics pass, then the gradient pass). On CUDA
    tensors each pass is its kernel; on CPU tensors its plain version.

    apply(theta, phi, g, offsets) -> (B, D, H, W, G)."""

    @staticmethod
    def forward(ctx, theta, phi, g, offsets):
        ctx.offsets = offsets
        ctx.save_for_backward(theta, phi, g)
        return _forward(theta, phi, g, offsets)

    @staticmethod
    def backward(ctx, ybar):
        theta, phi, g = ctx.saved_tensors
        ybar = ybar.contiguous()
        scal = stencil_attention_scal(theta, phi, g, ybar, ctx.offsets)
        dtheta, dphi, dg = stencil_attention_bwd(theta, phi, g, ybar, scal,
                                                 ctx.offsets)
        return dtheta, dphi, dg, None


def stencil_attention(theta, phi, g, offsets=KERNEL_OFFSETS):
    """Kernel wrapper of stencil_attention_plain, differentiable through
    StencilAttentionFunction: CUDA tensors launch the plane ring (the
    18-offset stencil, F = G = 8) or the generic kernels (any other
    stencil and widths they take, else raise), forward and backward; CPU
    tensors take the plain versions. `.launches` counts the plane ring's
    forwards."""
    return StencilAttentionFunction.apply(theta, phi, g,
                                          tuple(map(tuple, offsets)))


stencil_attention.launches = 0


# the generic wrappers' plain twins (chip_smoke swaps each wrapper `w` for
# `w_plain` in its reference run)
stencil_attention_generic_plain = stencil_attention_plain
stencil_attention_scal_generic_plain = stencil_attention_scal_plain
stencil_attention_bwd_generic_plain = stencil_attention_bwd_plain

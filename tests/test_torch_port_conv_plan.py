"""Host-side geometry of the Hopper conv kernels (csrc/conv3x3x3.cu,
csrc/conv3x3x3_dw.cu), rehearsed on the CPU. The kernels run only on the
card. dram_tpu_torch/kernels/conv_stack.py decides their launch geometry
(conv_plan, dw_plan: N tile, z-planes per warpgroup, tile grid, split of
K, statistics rows; the `args` vector the launchers run), packs the
weights and zero-pads channel parts to multiples of 8 (pad8); those are
the code under test here.

What the kernels do inside a tile is compiled arithmetic in the CUDA
sources, which these tests cannot call. The helpers below (tile_origin,
conv_tap_row, dw_tap_row, tensor_map) are a copy of it: the tile decode
(fwd_tile), the halo rows a tap's wgmma reads (arow) and the tensor maps
the launchers encode (wg_map). An emulation reads every box those TMA
loads would read (zero outside the tensor), takes each tap's rows from
the halo, multiplies them with the packed weights or the dy box, and
writes the rows the epilogue writes; in f32 it must equal F.conv3d and
aten's conv weight gradient (rtol 1e-5: the same products summed in
another order). So a wrong plan fails here, while a kernel that departs
from the copy fails chip_smoke.py's conv sweep, which holds every
flagship launch against its plain version on the card. The copies keep
each flagship level's ragged x extent against the 8-voxel box (W = 10,
20, 40), two input parts, split outputs and Co = 32."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dram_tpu_torch.kernels import conv_stack as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HALO_Y = cs.BOX_Y + 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulation is thousands of small tensor operations: one torch
    thread each, so that six test workers do not each run eight threads
    on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_conv_shapes", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- a copy of the kernels' compiled arithmetic -------------------------------


def tile_origin(tiles, m):
    """Batch element and tile (b, tz, ty, tx) of M tile m, tiles (along
    x, y, z) = (nbx, nby, nbz): fwd_tile in conv3x3x3.cu, the K-box decode
    in conv3x3x3_dw.cu."""
    nbx, nby, nbz = tiles
    m, tx = divmod(m, nbx)
    m, ty = divmod(m, nby)
    b, tz = divmod(m, nbz)
    return b, tz, ty, tx


def conv_tap_row(zl, dzi, dyi):
    """First halo row of the 64 rows (one wgmma's A) that output z-plane
    zl of a conv tile reads for the tap (dz, dy) = (dzi - 1, dyi - 1):
    arow in conv3x3x3.cu."""
    return ((zl + dzi) * HALO_Y + dyi) * cs.BOX_X


def dw_tap_row(ks, dzi, dyi):
    """First halo row of the 16 voxel rows (one wgmma's K) that K step ks
    of a weight-gradient box reads for the tap (dz, dy); its dy rows are
    16 ks .. 16 ks + 15 of the box: arow in conv3x3x3_dw.cu."""
    return ((ks // 4 + dzi) * HALO_Y + (ks % 4) * 2 + dyi) * cs.BOX_X


def tensor_map(shape, box):
    """The bf16 tensor map the launchers encode (wg_map) for a dense
    tensor of `shape` (outermost first): (dims innermost first, byte
    strides of dims 1.., box); out-of-bounds box elements read as zero."""
    dims = tuple(int(d) for d in reversed(shape))
    strides, st = [], 2
    for d in dims[:-1]:
        st *= d
        strides.append(st)
    return dims, tuple(strides), tuple(box)


def conv_maps(B, D, H, W, C1, C2, Co, plan):
    bz = plan["box"][2]
    halo = (cs.CHUNK, cs.BOX_X, HALO_Y, bz + 2, 1)
    maps = {"x1": tensor_map((B, D, H, W, C1), halo),
            "w": tensor_map((27, Co, C1 + C2), (cs.CHUNK, plan["bn"], 1))}
    if C2:
        maps["x2"] = tensor_map((B, D, H, W, C2), halo)
    return maps


def dw_maps(B, D, H, W, C1, C2, Co):
    halo = (cs.CHUNK, cs.BOX_X, HALO_Y, cs.DW_BZ + 2, 1)
    maps = {"x1": tensor_map((B, D, H, W, C1), halo),
            "dy": tensor_map((B, D, H, W, Co),
                             (cs.CHUNK, cs.BOX_X, cs.BOX_Y, cs.DW_BZ, 1))}
    if C2:
        maps["x2"] = tensor_map((B, D, H, W, C2), halo)
    return maps


def tma_read(t, tmap, coords):
    """What a TMA load with tensor map `tmap` (tensor_map above) at
    box origin `coords` (innermost first) writes to shared memory: the box
    of `t` (outermost first), zero outside the tensor."""
    dims, strides, box = tmap
    assert tuple(t.shape) == tuple(reversed(dims))
    # the maps describe dense tensors: byte strides of bf16 elements
    assert strides == tuple(2 * int(np.prod(dims[:i + 1]))
                            for i in range(len(dims) - 1))
    out = torch.zeros(tuple(reversed(box)), dtype=t.dtype)
    src, dst = [], []
    for d, c, n in zip(reversed(dims), reversed(coords), reversed(box)):
        lo, hi = max(c, 0), min(c + n, d)
        if lo >= hi:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - c, hi - c))
    out[tuple(dst)] = t[tuple(src)]
    return out


def _prologue_halo(halo, origin, shape, cvalid, s, t):
    """The kernels' in-place prologue (wg::prologue_halo) on an emulated
    halo (rows x 64): relu(x s + t) on the voxels inside the volume and
    the chunk's valid channels, zero elsewhere."""
    x0, y0, z0 = origin
    D, H, W = shape
    r = torch.arange(halo.shape[0])
    x = x0 + r % cs.BOX_X
    y = y0 + (r // cs.BOX_X) % HALO_Y
    z = z0 + r // (cs.BOX_X * HALO_Y)
    inside = (x >= 0) & (x < W) & (y >= 0) & (y < H) & (z >= 0) & (z < D)
    ch = torch.arange(64) < cvalid
    y_ = torch.relu(halo * s + t)
    return torch.where(inside[:, None] & ch[None, :], y_, 0.0)


def emulate_conv(x1, x2, w, Co1, prologue=None):
    """The wgmma conv kernel's schedule on the CPU in f32: returns
    (y1, y2, statistics rows) for w (Co, C1 + C2, 3, 3, 3)."""
    B, D, H, W, C1 = x1.shape
    C2 = x2.shape[-1] if x2 is not None else 0
    Co = w.shape[0]
    plan = cs.conv_plan(B, D, H, W, C1, C2, Co)
    bn, bz = plan["bn"], plan["box"][2]
    maps = conv_maps(B, D, H, W, C1, C2, Co, plan)
    halo_rows = (bz + 2) * HALO_Y * cs.BOX_X
    wk = cs.pack_weight(w).float()
    assert maps["w"][0] == (C1 + C2, Co, 27)
    y = torch.full((B, D, H, W, Co), float("nan"))
    stats = torch.zeros(plan["stat_rows"], 2, Co)
    for m in range(plan["m_tiles"]):
        b, tz, ty, tx = tile_origin(plan["tiles"], m)
        x0, y0, z0 = tx * cs.BOX_X, ty * cs.BOX_Y, tz * bz
        for nt in range(plan["n_tiles"]):
            n0 = nt * bn
            acc = torch.zeros(bz, 64, bn)
            for part, cl, cg, cvalid in cs.k_chunks(C1, C2):
                src, key = (x1, "x1") if part == 0 else (x2, "x2")
                for dxi in range(3):
                    halo = tma_read(src, maps[key],
                                    (cl, x0 + dxi - 1, y0 - 1, z0 - 1, b))
                    halo = halo.reshape(halo_rows, 64)
                    if prologue is not None:
                        s, t = (v[cg:cg + 64] for v in prologue)
                        s = torch.nn.functional.pad(s, (0, 64 - len(s)))
                        t = torch.nn.functional.pad(t, (0, 64 - len(t)))
                        halo = _prologue_halo(
                            halo, (x0 + dxi - 1, y0 - 1, z0 - 1), (D, H, W),
                            cvalid, s, t)
                    for t9 in range(9):
                        dzi, dyi = divmod(t9, 3)
                        tap = dzi * 9 + dyi * 3 + dxi
                        wt = tma_read(wk, maps["w"],
                                      (cg, n0, tap)).reshape(bn, 64)
                        for zl in range(bz):
                            r0 = conv_tap_row(zl, dzi, dyi)
                            acc[zl] += halo[r0:r0 + 64] @ wt.T
            # epilogue: the rows inside the volume, columns < Co
            for zl in range(bz):
                for r in range(64):
                    xx, yy, zz = x0 + r % 8, y0 + r // 8, z0 + zl
                    if xx < W and yy < H and zz < D:
                        cols = min(bn, Co - n0)
                        y[b, zz, yy, xx, n0:n0 + cols] = acc[zl, r, :cols]
                        stats[m, 0, n0:n0 + cols] += acc[zl, r, :cols]
                        stats[m, 1, n0:n0 + cols] += acc[zl, r, :cols] ** 2
    return y[..., :Co1], y[..., Co1:], stats


def emulate_dw(x1, x2, dy, prologue=None):
    """The wgmma weight-gradient kernel's schedule on the CPU in f32: the
    (nsplit, 27 Ci, Co) partial tiles its blocks write."""
    B, D, H, W, C1 = x1.shape
    C2 = x2.shape[-1] if x2 is not None else 0
    Ci, Co = C1 + C2, dy.shape[-1]
    plan = cs.dw_plan(B, D, H, W, C1, C2, Co)
    chunks = cs.k_chunks(C1, C2)
    n_co = -(-Co // 64)
    assert plan["grid"] == (3 * len(chunks), n_co, plan["nsplit"])
    maps = dw_maps(B, D, H, W, C1, C2, Co)
    halo_rows = (cs.DW_BZ + 2) * HALO_Y * cs.BOX_X
    part = torch.full((plan["nsplit"], 27 * Ci, Co), float("nan"))
    rows = {(dzi, dyi): torch.cat([
        torch.arange(dw_tap_row(ks, dzi, dyi),
                     dw_tap_row(ks, dzi, dyi) + 16) for ks in range(8)])
        for dzi in range(3) for dyi in range(3)}
    for split in range(plan["nsplit"]):
        kb0 = split * plan["kboxes"]
        kb1 = min(kb0 + plan["kboxes"], plan["nboxes"])
        for p_, cl, cg, cvalid in chunks:
            src, key = (x1, "x1") if p_ == 0 else (x2, "x2")
            for dxi in range(3):
                for nt in range(n_co):
                    n0 = nt * 64
                    acc = torch.zeros(27, 64, 64)
                    for kb in range(kb0, kb1):
                        b, tz, ty, tx = tile_origin(plan["tiles"], kb)
                        x0, y0, z0 = tx * 8, ty * 8, tz * cs.DW_BZ
                        halo = tma_read(src, maps[key],
                                        (cl, x0 + dxi - 1, y0 - 1, z0 - 1,
                                         b)).reshape(halo_rows, 64)
                        if prologue is not None:
                            s, t = (torch.nn.functional.pad(
                                v[cg:cg + 64], (0, 64 - len(v[cg:cg + 64])))
                                for v in prologue)
                            halo = _prologue_halo(
                                halo, (x0 + dxi - 1, y0 - 1, z0 - 1),
                                (D, H, W), cvalid, s, t)
                        dyb = tma_read(dy, maps["dy"],
                                       (n0, x0, y0, z0, b)).reshape(128, 64)
                        for (dzi, dyi), idx in rows.items():
                            acc[dzi * 9 + dyi * 3 + dxi] += halo[idx].T @ dyb
                    cols = min(64, Co - n0)
                    for tap in range(27):
                        if (tap % 3) != dxi:
                            continue
                        part[split, tap * Ci + cg:tap * Ci + cg + cvalid,
                             n0:n0 + cols] = acc[tap, :cvalid, :cols]
    return part


def _rand(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


# small copies of the flagship's levels (PERF.md: 80^3, 40^3, 20^3, 10^3)
# at their box raggedness: (B, D, H, W, C1, C2, Co, Co1)
FWD_CASES = {
    "80-level two parts, Co 32": (1, 4, 16, 16, 24, 16, 32, 32),
    "40-level W 40": (1, 4, 8, 40, 16, 0, 64, 64),
    "20-level ragged, two chunks": (2, 6, 20, 20, 72, 0, 128, 128),
    "10-level ragged, N 256": (2, 10, 10, 10, 64, 32, 256, 256),
    "split output 48 | 16": (1, 4, 10, 10, 16, 0, 64, 48),
    "two N tiles of 256": (1, 2, 10, 10, 16, 0, 512, 512),
}


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_conv_plan_emulation_equals_conv3d(case):
    B, D, H, W, C1, C2, Co, Co1 = FWD_CASES[case]
    rng = np.random.default_rng(7)
    x1, w = _rand(rng, B, D, H, W, C1), _rand(rng, Co, C1 + C2, 3, 3, 3)
    x2 = _rand(rng, B, D, H, W, C2) if C2 else None
    # bf16 values: the packing rounds the weights, as the kernel's does
    x1 = x1.bfloat16().float()
    x2 = x2.bfloat16().float() if x2 is not None else None
    w = w.bfloat16().float()
    y1, y2, stats = emulate_conv(x1, x2, w, Co1)
    xcat = x1 if x2 is None else torch.cat([x1, x2], -1)
    want = F.conv3d(xcat.permute(0, 4, 1, 2, 3), w, padding=1) \
        .permute(0, 2, 3, 4, 1)
    tol = dict(rtol=1e-5, atol=1e-5 * want.abs().max().item())
    torch.testing.assert_close(y1, want[..., :Co1], **tol)
    torch.testing.assert_close(y2, want[..., Co1:], **tol)
    # one statistics row per M tile; their sum is the channel statistics
    tot = stats.sum(0)
    torch.testing.assert_close(tot[0], want.sum((0, 1, 2, 3)), rtol=1e-5,
                               atol=1e-4 * want.abs().sum().item() / Co)
    torch.testing.assert_close(tot[1], (want ** 2).sum((0, 1, 2, 3)),
                               rtol=1e-5, atol=1e-5)


def test_conv_plan_emulation_prologue():
    """The prologue on the staged halo, zero outside the volume and past
    Ci after the affine, equals F.conv3d of relu(x s + t) zero-padded."""
    rng = np.random.default_rng(8)
    B, D, H, W, C = 1, 5, 12, 20, 24
    x = _rand(rng, B, D, H, W, C)
    w = _rand(rng, 32, C, 3, 3, 3).bfloat16().float()
    s = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32))
    t = torch.from_numpy(rng.uniform(0.1, 0.5, C).astype(np.float32))
    y1, _, _ = emulate_conv(x, None, w, 32, prologue=(s, t))
    want = F.conv3d(torch.relu(x * s + t).permute(0, 4, 1, 2, 3), w,
                    padding=1).permute(0, 2, 3, 4, 1)
    torch.testing.assert_close(y1, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


DW_CASES = {
    "80-level two parts": (1, 4, 8, 16, 24, 16, 64),
    "40-level W 40": (1, 2, 8, 40, 16, 0, 64),
    "20-level ragged, two Co tiles": (2, 3, 20, 20, 72, 0, 128),
    "10-level ragged, two parts": (1, 10, 10, 10, 64, 32, 96),
}


def _conv_weight_grad(x, dy):
    Co, Ci = dy.shape[-1], x.shape[-1]
    w = torch.zeros((Co, Ci, 3, 3, 3))
    _, dw, _ = torch.ops.aten.convolution_backward(
        dy.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3), w, None,
        [1, 1, 1], [1, 1, 1], [1, 1, 1], False, [0, 0, 0], 1,
        [False, True, False])
    return dw


@pytest.mark.parametrize("case", sorted(DW_CASES))
def test_dw_plan_emulation_equals_weight_grad(case):
    B, D, H, W, C1, C2, Co = DW_CASES[case]
    rng = np.random.default_rng(9)
    x1, dy = _rand(rng, B, D, H, W, C1), _rand(rng, B, D, H, W, Co)
    x2 = _rand(rng, B, D, H, W, C2) if C2 else None
    part = emulate_dw(x1, x2, dy)
    assert not torch.isnan(part).any()  # every (tap, ci, co) written
    got = part.sum(0).view(3, 3, 3, C1 + C2, Co).permute(4, 3, 0, 1, 2)
    xcat = x1 if x2 is None else torch.cat([x1, x2], -1)
    want = _conv_weight_grad(xcat, dy)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


def test_dw_plan_emulation_prologue():
    rng = np.random.default_rng(10)
    B, D, H, W, C, Co = 1, 3, 10, 20, 16, 64
    x, dy = _rand(rng, B, D, H, W, C), _rand(rng, B, D, H, W, Co)
    s = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32))
    t = torch.from_numpy(rng.uniform(0.1, 0.5, C).astype(np.float32))
    got = emulate_dw(x, None, dy, prologue=(s, t)).sum(0) \
        .view(3, 3, 3, C, Co).permute(4, 3, 0, 1, 2)
    want = _conv_weight_grad(torch.relu(x * s + t), dy)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


@functools.lru_cache(maxsize=None)
def conv_shapes():
    return _chip_smoke().conv_shapes()


def _flagship_steps():
    """(kind, B, edge, (C1, C2), Co) of the flagship training step's
    launches of the wgmma kernels at batch 10: 13 forward, 13 dx and 13
    dW. The network-entry conv's forward and dW run csrc/conv3x3x3_c1.cu
    (conv_stack.c1_takes), and its CT input takes no dx."""
    out = []
    for name, e, (c1, c2), co in conv_shapes():
        if name == "ds_0.conv_0":
            continue
        out.append(("fwd", 10, e, (c1, c2), co))
        out.append(("dx", 10, e, (co, 0), (c1, c2)))
        out.append(("dw", 10, e, (c1, c2), co))
    return out


# the flagship DC3D's convs: (name, edge at 80^3, (C1, C2), Co)
FLAGSHIP = [
    ("ds_0.conv_0", 80, (1, 0), 32), ("ds_0.conv_1", 80, (32, 0), 64),
    ("ds_1.conv_0", 40, (64, 0), 64), ("ds_1.conv_1", 40, (64, 0), 128),
    ("ds_2.conv_0", 20, (128, 0), 128), ("ds_2.conv_1", 20, (128, 0), 256),
    ("bg.conv_0", 10, (256, 0), 256), ("bg.conv_1", 10, (256, 0), 512),
    ("us_0.conv_0", 20, (512, 256), 256), ("us_0.conv_1", 20, (256, 0), 256),
    ("us_1.conv_0", 40, (256, 128), 128), ("us_1.conv_1", 40, (128, 0), 128),
    ("us_2.conv_0", 80, (128, 64), 64), ("us_2.conv_1", 80, (64, 0), 64)]


def test_flagship_conv_shapes_match_the_model():
    """chip_smoke.conv_shapes(), read from a meta-device DC3D, lists the
    flagship's 14 convs in forward order with their input parts."""
    assert conv_shapes() == FLAGSHIP
    steps = _flagship_steps()
    assert [k for k, *_ in steps].count("dx") == 13


def test_dw_plan_covers_each_voxel_once():
    """At every flagship dW shape the K boxes of the splits tile the batch's
    voxels, each voxel once (boxes clipped to the volume)."""
    seen = set()
    for kind, B, e, (c1, c2), co in _flagship_steps():
        if kind != "dw" or e in seen:
            continue
        seen.add(e)
        plan = cs.dw_plan(B, e, e, e, c1, c2, co)
        count = np.zeros((B, e, e, e), np.int32)
        covered = 0
        for split in range(plan["nsplit"]):
            kb0 = split * plan["kboxes"]
            kb1 = min(kb0 + plan["kboxes"], plan["nboxes"])
            assert kb1 > kb0
            for kb in range(kb0, kb1):
                b, tz, ty, tx = tile_origin(plan["tiles"], kb)
                count[b, tz * 2:tz * 2 + 2, ty * 8:ty * 8 + 8,
                      tx * 8:tx * 8 + 8] += 1
            covered = kb1
        assert covered == plan["nboxes"]
        assert (count == 1).all()
        assert plan["args"] == (*plan["tiles"], plan["nboxes"],
                                plan["kboxes"], plan["nsplit"])
        assert np.prod(plan["grid"]) <= cs.DW_TARGET_BLOCKS


def test_conv_tiles_cover_each_output_voxel_once():
    for e, co in ((80, 64), (40, 128), (20, 256), (10, 512)):
        p = cs.conv_plan(2, e, e, e, 64, 0, co)
        bz, tiles = p["box"][2], p["tiles"]
        count = np.zeros((2, e + 8, e + 8, e + 8), np.int32)
        for m in range(p["m_tiles"]):
            b, tz, ty, tx = tile_origin(tiles, m)
            count[b, tz * bz:tz * bz + bz, ty * 8:ty * 8 + 8,
                  tx * 8:tx * 8 + 8] += 1
        assert (count[:, :e, :e, :e] == 1).all()
        assert count.sum() == p["m_tiles"] * 64 * bz


def test_flagship_routing():
    """Every flagship conv launch runs a Hopper kernel on its channels as
    they are. The network-entry conv (Ci = 1) is the only conv whose input
    is not a multiple of 8 channels, and c1_takes it: its forward and dW
    run csrc/conv3x3x3_c1.cu (tests/test_torch_port_entry_conv.py). Every
    wgmma launch's input parts are multiples of 8, so pad8 returns them as
    they are, and every output part is even. pad8 stays for other widths:
    on (12, 5) -> 6 the padding changes neither the conv nor, after
    unpad_dw, its weight gradient."""
    odd = [(n, e, parts) for n, e, parts, _ in conv_shapes()
           if any(c % 8 for c in parts)]
    assert odd == [("ds_0.conv_0", 80, (1, 0))]
    for name, e, (c1, c2), co in conv_shapes():
        x1 = torch.empty(1, 1, 1, 1, c1, device="meta")
        x2 = torch.empty(1, 1, 1, 1, c2, device="meta") if c2 else None
        assert cs.c1_takes(x1, x2, None) == (name == "ds_0.conv_0")
        # a conv_1's prologue (training) never takes the c1 kernels
        assert not cs.c1_takes(x1, x2, (x1, x1))
    for kind, B, e, ins, outs in _flagship_steps():
        assert all(c % 8 == 0 for c in ins), (kind, e, ins)
        t = torch.empty(1, sum(ins), device="meta")
        assert cs.pad8(t, ins) is t
        if kind == "dx":  # the split output's parts
            assert all(c % 2 == 0 for c in outs), (kind, e, outs)
    rng = np.random.default_rng(12)
    C1, C2, Co = 12, 5, 6
    x1, x2 = _rand(rng, 1, 4, 6, 10, C1), _rand(rng, 1, 4, 6, 10, C2)
    dy = _rand(rng, 1, 4, 6, 10, Co)
    w = _rand(rng, Co, C1 + C2, 3, 3, 3)
    x = torch.cat([x1, x2], -1)
    xp = torch.cat([cs.pad8(x1), cs.pad8(x2)], -1)
    wp = cs.pad8(w, (C1, C2), 1)
    assert xp.shape[-1] % 8 == 0 and wp.shape[1] == xp.shape[-1]
    want = F.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=1)
    got = F.conv3d(xp.permute(0, 4, 1, 2, 3), wp, padding=1)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    want = _conv_weight_grad(x, dy)
    got = cs.unpad_dw(_conv_weight_grad(xp, cs.pad8(dy)), C1, C2, Co)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


def test_conv_plan_tiles_and_launch_vector():
    """N tiles, z-planes per warpgroup, the tile grid and the vector the
    launcher runs, at the flagship's shapes."""
    expect_bn = {32: 32, 64: 64, 128: 128, 192: 64, 256: 256, 384: 128,
                 512: 256, 768: 256}
    for kind, B, e, (c1, c2), co in _flagship_steps():
        if kind == "dw":
            continue
        n = sum(co) if isinstance(co, tuple) else co
        p = cs.conv_plan(B, e, e, e, c1, c2, n)
        assert p["bn"] == expect_bn[n]
        assert p["slabs"] == (2 if p["bn"] <= 128 else 1)
        bz = 2 * p["slabs"]
        assert p["box"] == (8, 8, bz)
        assert p["tiles"] == (-(-e // 8), -(-e // 8), -(-e // bz))
        assert p["m_tiles"] == p["stat_rows"] == B * int(np.prod(p["tiles"]))
        assert p["args"] == (p["bn"], p["slabs"], *p["tiles"],
                             p["m_tiles"], -(-n // p["bn"]))
        # each K chunk lies in one part and starts at its channel in Ci
        assert sum(c[3] for c in cs.k_chunks(c1, c2)) == c1 + c2


def test_tensor_maps_meet_tma_rules():
    """Global strides multiples of 16 bytes, box dims <= 256 and a
    128-byte inner box extent for every flagship launch."""
    for kind, B, e, (c1, c2), co in _flagship_steps():
        if kind == "dw":
            maps = dw_maps(B, e, e, e, c1, c2, co)
        else:
            n = sum(co) if isinstance(co, tuple) else co
            maps = conv_maps(B, e, e, e, c1, c2, n,
                             cs.conv_plan(B, e, e, e, c1, c2, n))
        for dims, strides, box in maps.values():
            assert all(st % 16 == 0 for st in strides)
            assert all(1 <= b <= 256 for b in box) and box[0] * 2 == 128
            assert len(dims) == len(box) == len(strides) + 1


def test_pack_weight_layout():
    rng = np.random.default_rng(11)
    w = _rand(rng, 6, 5, 3, 3, 3)
    wk = cs.pack_weight(w)
    assert wk.shape == (27, 6, 5) and wk.dtype == torch.bfloat16
    for kd, kh, kw in ((0, 0, 0), (1, 2, 0), (2, 1, 2)):
        tap = kd * 9 + kh * 3 + kw
        torch.testing.assert_close(wk[tap].float(),
                                   w[:, :, kd, kh, kw].bfloat16().float())


def test_k_chunks_of_two_parts():
    assert cs.k_chunks(128, 64) == [(0, 0, 0, 64), (0, 64, 64, 64),
                                    (1, 0, 128, 64)]
    assert cs.k_chunks(72, 8) == [(0, 0, 0, 64), (0, 64, 64, 8),
                                  (1, 0, 72, 8)]
    assert cs.k_chunks(32, 0) == [(0, 0, 0, 32)]

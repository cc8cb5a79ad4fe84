"""The tile plans of csrc/upsample2x.cu (kernels/upsample.py:fwd_plan,
bwd_plan), emulated on the CPU at every upsample launch shape of the
flagship's scan (batch 5), its training step (batch 10) and the training
golden's step (batch 2 x 48^3): a copy of the kernels' in-tile arithmetic
(staged row, column and plane spans, the plane ring and its loads ahead,
the forward's three-column register window, the adjoint's four-tap
windows along x and y and its two plane accumulators) run tile by tile,
and held against upsample2x_plain / upsample2x_bwd_plain. Each output is
written exactly once. The plan is the launch's (real batch and
channels); the emulated data is one batch element of 8 channels, since a
tile's arithmetic is the same for every batch element and channel group.
Keep this copy in step with the .cu file."""

import numpy as np
import pytest
import torch

from dram_tpu_torch.kernels import upsample as up

# (B, n, C) per launch: the scan's and the step's three decoder levels
# (10^3 x 512, 20^3 x 256, 40^3 x 128 inputs), the golden's (6^3 .. 24^3)
LAUNCHES = [(B, n, C) for B in (5, 10) for n, C in ((10, 512), (20, 256),
                                                     (40, 128))] \
    + [(2, 6, 512), (2, 12, 256), (2, 24, 128)]
CH = 8


def adjoint_weights(n):
    """(n, 4) f32 weights of input i on outputs 2i - 1 + k, k = 0..3 (zero
    outside the axis): the adjoint kernel's per-block table, (1 - f) where
    lo = i plus f where hi = i, in f32."""
    lo, hi, f = up.axis_taps(n)
    w = torch.zeros((n, 4), dtype=torch.float32)
    for i in range(n):
        for k in range(4):
            o = 2 * i - 1 + k
            if 0 <= o < 2 * n:
                fo = torch.tensor(f[o], dtype=torch.float32)
                w[i, k] = (1.0 - fo if lo[o] == i else 0.0) \
                    + (fo if hi[o] == i else 0.0)
    return w


def _vol(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


def _tiles(plan, ext):
    zr, yr, xr = plan["run"]
    tx, ty, tz = plan["tiles"]
    for z in range(tz):
        for y in range(ty):
            for x in range(tx):
                yield ((z * zr, min(z * zr + zr, ext[0])),
                       (y * yr, min(y * yr + yr, ext[1])),
                       (x * xr, min(x * xr + xr, ext[2])))


def emulate_fwd(x, plan):
    """csrc/upsample2x.cu's forward, tile by tile, on x (D, H, W, c)."""
    D, H, W, c = x.shape
    (lz_, hz_, fz_), (ly_, hy_, fy_), (lx_, hx_, fx_) = (
        up.axis_taps(n) for n in (D, H, W))
    out = torch.zeros((2 * D, 2 * H, 2 * W, c))
    count = torch.zeros((2 * D, 2 * H, 2 * W), dtype=torch.int32)
    for (za, zb), (ya, yb), (xa, xb) in _tiles(plan, (2 * D, 2 * H, 2 * W)):
        pz0, pz1 = lz_[za], hz_[zb - 1]
        ry0, ry1, cx0, cx1 = ly_[ya], hy_[yb - 1], lx_[xa], hx_[xb - 1]
        assert ry1 - ry0 + 1 <= plan["rows"] and cx1 - cx0 + 1 <= plan["cols"]
        ring = [None] * up.FWD_NBUF
        loaded = min(pz0 + up.FWD_NBUF - 1, pz1)
        for pl in range(pz0, loaded + 1):
            ring[(pl - pz0) % up.FWD_NBUF] = pl
        # the threads' rows and columns (segments of FWD_SX from xa)
        rows = torch.arange(ya, yb)
        xo = torch.arange(xa, min(xa + plan["nseg"] * up.FWD_SX, xb))
        ly = torch.tensor([ly_[r] for r in rows]) - ry0
        hy = torch.tensor([hy_[r] for r in rows]) - ry0
        fy = torch.tensor([fy_[r] for r in rows])[:, None, None]
        base = (xo >> 1) - 1
        d = torch.tensor([lx_[o] for o in xo]) - base
        assert ((d == 0) | (d == 1)).all()
        fx = torch.tensor([fx_[o] for o in xo])[None, :, None]
        ca = (torch.clamp(base + d, cx0, cx1) - cx0)
        cb = (torch.clamp(base + d + 1, cx0, cx1) - cx0)
        for zo in range(za, zb):
            lz, hz, fz = lz_[zo], min(lz_[zo] + 1, D - 1), fz_[zo]
            want = min(hz + 1, pz1)
            for pl in range(loaded + 1, want + 1):
                old = ring[(pl - pz0) % up.FWD_NBUF]
                assert old is None or old < lz
                ring[(pl - pz0) % up.FWD_NBUF] = pl
            loaded = max(loaded, want)
            assert ring[(lz - pz0) % up.FWD_NBUF] == lz
            assert ring[(hz - pz0) % up.FWD_NBUF] == hz
            A = x[lz, ry0:ry1 + 1, cx0:cx1 + 1]
            Bz = x[hz, ry0:ry1 + 1, cx0:cx1 + 1]
            # the z- and y-lerp of every staged column, per output row
            col = (1 - fz) * (1 - fy) * A[ly] + (1 - fz) * fy * A[hy] \
                + fz * (1 - fy) * Bz[ly] + fz * fy * Bz[hy]
            a, b = col[:, ca], col[:, cb]
            out[zo, ya:yb, xo[0]:xo[-1] + 1] = a + fx * (b - a)
            count[zo, ya:yb, xo[0]:xo[-1] + 1] += 1
    assert (count == 1).all()
    return out


def emulate_bwd(dy, plan):
    """csrc/upsample2x.cu's adjoint, tile by tile, on dy (2D, 2H, 2W, c):
    per staged dy plane, the x reduction over four columns, then the y
    reduction over four rows, spread over the two plane accumulators."""
    D2, H2, W2, c = dy.shape
    D, H, W = D2 // 2, H2 // 2, W2 // 2
    lz_, hz_, fz_ = up.axis_taps(D)
    wy_all, wx_all = adjoint_weights(H), adjoint_weights(W)
    out = torch.zeros((D, H, W, c))
    count = torch.zeros((D, H, W), dtype=torch.int32)
    for (za, zb), (ya, yb), (xa, xb) in _tiles(plan, (D, H, W)):
        pz0, pz1 = max(2 * za - 1, 0), min(2 * zb, D2 - 1)
        ry0, ry1 = max(2 * ya - 1, 0), min(2 * yb, H2 - 1)
        cx0, cx1 = max(2 * xa - 1, 0), min(2 * xb, W2 - 1)
        assert ry1 - ry0 + 1 <= plan["rows"] and cx1 - cx0 + 1 \
            <= plan["cols"] and pz1 - pz0 + 1 <= plan["planes"]
        xi = torch.arange(xa, min(xa + plan["nseg"] * up.BWD_SX, xb))
        yi = torch.arange(ya, yb)
        taps = torch.arange(4)
        cols = torch.clamp(2 * xi[:, None] - 1 + taps, cx0, cx1) - cx0
        rws = torch.clamp(2 * yi[:, None] - 1 + taps, ry0, ry1) - ry0
        wx, wy = wx_all[xi], wy_all[yi]
        ring = [None] * up.BWD_NBUF
        for pl in range(pz0, min(pz0 + up.BWD_NBUF - 1, pz1) + 1):
            ring[(pl - pz0) % up.BWD_NBUF] = pl
        cur = za - 1
        acc = [torch.zeros((len(yi), len(xi), c)) for _ in range(2)]

        def store(plane, a):
            if za <= plane < zb:
                out[plane, ya:yb, xi[0]:xi[-1] + 1] = a
                count[plane, ya:yb, xi[0]:xi[-1] + 1] += 1
        for pl in range(pz0, pz1 + 1):
            lz, fz = lz_[pl], fz_[pl]
            hz = min(lz + 1, D - 1)
            if lz > cur:
                store(cur, acc[0])
                acc = [acc[1], torch.zeros_like(acc[1])]
                cur += 1
            assert lz == cur
            wc = (1 - fz) + (fz if hz == cur else 0.0)
            wn = fz if hz == cur + 1 else 0.0
            assert ring[(pl - pz0) % up.BWD_NBUF] == pl
            S = dy[pl, ry0:ry1 + 1, cx0:cx1 + 1]
            q = (S[:, cols] * wx[None, :, :, None]).sum(2)  # x taps
            P = (q[rws] * wy[:, :, None, None]).sum(1)       # y taps
            acc[0] = acc[0] + wc * P
            acc[1] = acc[1] + wn * P
            if pl + up.BWD_NBUF <= pz1:
                ring[(pl - pz0) % up.BWD_NBUF] = pl + up.BWD_NBUF
        store(cur, acc[0])
        store(cur + 1, acc[1])
    assert (count == 1).all()
    return out


@pytest.mark.parametrize("B,n,C", LAUNCHES)
def test_fwd_plan_emulated(B, n, C):
    plan = up.fwd_plan(B, n, n, n, C)
    assert plan["threads"] <= up.FWD_THREADS
    assert plan["smem"] <= up.SMEM_BUDGET
    x = _vol((n, n, n, CH), n)
    got = emulate_fwd(x, plan)
    want = up.upsample2x_plain(x[None])[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,n,C", LAUNCHES)
def test_bwd_plan_emulated(B, n, C):
    plan = up.bwd_plan(B, n, n, n, C)
    assert plan["threads"] <= up.BWD_THREADS
    assert plan["smem"] <= up.SMEM_BUDGET
    dy = _vol((2 * n, 2 * n, 2 * n, CH), n + 1)
    got = emulate_bwd(dy, plan)
    want = up.upsample2x_bwd_plain(dy[None])[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_odd_and_uneven_shapes_emulated():
    """Edges the flagship does not launch: odd sizes, unequal axes, runs
    that do not divide the extents, one-voxel axes."""
    for shape, runs in (((3, 5, 7), (4, 2, 6)), ((1, 2, 9), (2, 1, 8)),
                        ((5, 1, 3), (6, 2, 2))):
        D, H, W = shape
        x = _vol((D, H, W, CH), D)
        plan = up.fwd_plan(1, D, H, W, 64, runs=runs)
        torch.testing.assert_close(emulate_fwd(x, plan),
                                   up.upsample2x_plain(x[None])[0],
                                   rtol=1e-5, atol=1e-5)
        dy = _vol((2 * D, 2 * H, 2 * W, CH), W)
        plan = up.bwd_plan(1, D, H, W, 64, runs=(runs[0] // 2 or 1,
                                                 runs[1], runs[2] // 2 or 1))
        torch.testing.assert_close(emulate_bwd(dy, plan),
                                   up.upsample2x_bwd_plain(dy[None])[0],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bwd", [False, True])
def test_uncovering_plan_raises(bwd):
    plan = (up.bwd_plan if bwd else up.fwd_plan)(10, 40, 40, 40, 128)
    tx, ty, tz = plan["tiles"]
    for tiles in ((tx - 1, ty, tz), (tx, ty - 1, tz), (tx, ty, tz - 1)):
        with pytest.raises(ValueError, match="uncovered"):
            up._check(dict(plan, tiles=tiles), 10, 40, 40, 40, 128, bwd)
    with pytest.raises(ValueError, match="uncovered"):
        up._check(dict(plan, nseg=plan["nseg"] - 1), 10, 40, 40, 40, 128,
                  bwd)


def test_axis_windows_hold_up_to_160():
    """_check_axis: the forward's window and the adjoint's 2i-1 .. 2i+2
    taps hold for every axis length the port can meet."""
    for n in range(1, 161):
        up._check_axis(n)

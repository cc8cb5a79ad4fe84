"""The plane rings of the generic stencil-attention forward and gradient
pass (csrc/stencil_attention_generic.cu, csrc/stencil_attention_generic_bwd.cu,
csrc/stencil_generic_ring.cuh) on the CPU: their plans
(kernels/window_attention.py:generic_fwd_plan, generic_bwd_plan) cover
every voxel once within shared memory and thread limits; the ring's
protocol (the producer's staging, the sets' waits and releases) keeps
each release in its buffer's phase and never deadlocks; and a copy of
the kernels' tile-by-tile arithmetic (the staged boxes, the offsets dz
group by dz group, the online softmax, the -o side over i = j - o) equals
stencil_attention_plain / stencil_attention_bwd_plain on an asymmetric
k = 5 stencil. Keep this copy in step with the .cu files; the ring and
the staged boxes are tests/_torch_port_generic_ring.py's."""

import itertools

import numpy as np
import pytest
import torch

from _torch_port_generic_ring import (CASES, K5, STENCILS, VARIANT_A, Ring,
                                      Tile, case_offsets, covers_once,
                                      dz_groups, pad4, ring_order, tiles_of,
                                      volumes)
from dram_tpu_torch.kernels import window_attention as wa


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of small tensor operations: one thread each, so that the
    emulation does not contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_plans_cover_each_voxel_once():
    """Variant A's step shape, ragged grids and a grid narrower than a
    tile, at every halo, widths 1, 4, 16, 33 and 64, K = 1 and 343."""
    grids = [(10, 64, 64, 64), (2, 37, 45, 53), (1, 3, 5, 6), (2, 1, 1, 1)]
    widths = [(1, 1), (4, 4), (16, 4), (33, 1), (16, 64), (64, 64)]
    for (B, D, H, W), (F, G), h in itertools.product(grids, widths, range(4)):
        for kind, p in (("fwd", wa.generic_fwd_plan(B, D, H, W, F, G, h)),
                        *wa.generic_bwd_plan(B, D, H, W, F, G, h).items()):
            if kind == "args":
                continue
            covers_once(p, B, D, H, W)
            assert p["halo"] == h and p["lanes"] == wa.generic_class(F, G)[0]
    assert wa.generic_halo(((0, 0, 0),)) == 0
    assert len(wa.stencil_offsets(7, 3, True)) == 343
    assert wa.generic_halo(wa.stencil_offsets(7, 3, True)) == 3


def test_plan_that_uncovers_a_voxel_raises():
    p = dict(wa.generic_fwd_plan(2, 37, 45, 53, 16, 4, 2))
    for key, val in (("tiles", (p["tiles"][0] - 1, *p["tiles"][1:])),
                     ("rows", p["rows"] - 1), ("smem", p["smem"] + 16),
                     ("threads", p["threads"] + 32), ("nbuf", 1)):
        with pytest.raises(ValueError):
            wa._generic_check(dict(p, **{key: val}), 2, 37, 45, 53, 16, 4)
    with pytest.raises(ValueError):  # a ring too shallow for its sets
        wa.generic_fwd_plan(2, 37, 45, 53, 16, 4, 2, runs=(8, 8, 8), sets=3,
                            nbuf=6)
    with pytest.raises(ValueError):
        wa.generic_fwd_plan(0, 0, 4, 4, 16, 4, 1)


def test_dispatch_by_operands():
    """Which operands take which kernels and rings: every operand
    generic_takes takes the plane-ring generic kernels (none goes back to
    a one-thread-per-voxel kernel); variant A's on the whole ring in the
    <1, 4, 1> class; wide rows at halo 3 on the reload ring."""
    assert wa.ring_takes(wa.KERNEL_OFFSETS, 8, 8)
    assert not wa.ring_takes(VARIANT_A, 16, 4)
    assert wa.generic_takes(VARIANT_A, 16, 4)
    assert not wa.generic_takes(VARIANT_A, 65, 4)
    assert not wa.generic_takes(((4, 0, 0),), 8, 8)
    assert wa.generic_class(16, 4) == (1, 4, 1)
    assert wa.generic_class(8, 8) == (1, 4, 4)
    assert wa.generic_class(33, 1) == (4, 4, 4)
    assert wa.generic_class(64, 64) == (4, 4, 4)
    b = wa.generic_bwd_plan(10, 64, 64, 64, 16, 4, 2)
    f = wa.generic_fwd_plan(10, 64, 64, 64, 16, 4, 2)
    for p in (f, b["plus"], b["minus"]):
        assert p["reload"] == 0 and p["lanes"] == 1
        assert p["run"] == wa.GENERIC_RUNS[p["kind"]]
    # widths off a multiple of 4 launch on zero-padded channels
    t = torch.ones(1, 2, 2, 2, 5)
    padded = wa._pad4(t)
    assert padded.shape[-1] == 8 and padded[..., 5:].eq(0).all()
    assert torch.equal(wa._unpad(padded, 5), t) and wa._pad4(padded) is padded
    wide = wa.generic_bwd_plan(2, 64, 64, 64, 64, 64, 3)
    assert wide["minus"]["reload"] == 1 and wide["minus"]["lanes"] == 4
    assert wa.generic_bwd_plan(2, 64, 64, 64, 64, 64, 1)["minus"][
        "reload"] == 0


# --- the ring's protocol ------------------------------------------------------


def test_ring_protocol_never_deadlocks():
    """Every halo, set counts of one to 2h + 3 at the ring depth the plans
    take (and deeper rings), z-runs shorter and longer than the ring,
    both ring kinds; round-robin and random schedules. A ring one buffer
    short of 2h + sets + 1 deadlocks: the simulation sees it."""
    for h, D in itertools.product(range(4), (1, 2, 5, 9, 16)):
        offs = STENCILS[h]
        for sets, extra, zr in itertools.product(range(1, 2 * h + 4), (0, 2),
                                                 (1, 3, 8, 16)):
            p = wa.generic_fwd_plan(1, D, 4, 4, 4, 4, h, runs=(zr, 4, 4),
                                    sets=sets, nbuf=min(2 * h + sets + 1 + extra,
                                                        wa.GENERIC_MAX_NBUF))
            for tile, seed in itertools.product(tiles_of(p, D, 4, 4),
                                                (None, 0, 1)):
                assert sorted(ring_order(p, tile, D, offs, 1, seed)) == \
                    list(range(*tile[0]))
        short = dict(wa.generic_fwd_plan(1, 16, 4, 4, 4, 4, h,
                                         runs=(16, 4, 4), sets=2))
        short["nbuf"] -= 1
        with pytest.raises(AssertionError, match="deadlocked"):
            ring_order(short, next(tiles_of(short, 16, 4, 4)), 16, offs, 1)
        for sgn in (1, -1):
            p = wa.generic_fwd_plan(1, D, 4, 4, 4, 4, h, runs=(3, 4, 4),
                                    reload=1, nbuf=2)
            for tile in tiles_of(p, D, 4, 4):
                assert ring_order(p, tile, D, offs, sgn) == \
                    list(range(*tile[0]))


# --- the kernels' arithmetic, tile by tile ----------------------------------


def emulate_fwd(theta, phi, g, offsets, p):
    """stencil_attention_generic_kernel on one batch element: per tile
    and plane, theta of the voxel and the offsets dz group by dz group
    from the staged phi and g, with the online softmax."""
    D, H, W, G = g.shape
    out = torch.full_like(g, np.nan)
    count = torch.zeros((D, H, W), dtype=torch.int32)
    groups = dz_groups(offsets)
    K = len(offsets)
    for tile in tiles_of(p, D, H, W):
        t = Tile(tile, p, D, H, W)

        def compute(z, planes):
            th = pad4(theta[z, t.y, t.x])
            # the degree from coordinates: K where the voxel is h or more
            # from every face, else counted
            h = p["halo"]
            deg = torch.zeros_like(t.y)
            for dz, dy, dx in offsets:
                deg += ((0 <= z + dz < D) & (t.y + dy >= 0) & (t.y + dy < H)
                        & (t.x + dx >= 0) & (t.x + dx < W)).long()
            inner = (h <= z < D - h) & (t.y >= h) & (t.y < H - h) \
                & (t.x >= h) & (t.x < W - h)
            assert (deg[inner] == K).all()
            rs = torch.rsqrt(torch.clamp(deg.double(), min=1.0))
            m = torch.zeros_like(rs)
            den = torch.zeros_like(rs)
            acc = torch.zeros(len(t.y), pad4(g[:1, :1, :1]).shape[-1],
                              dtype=g.dtype)
            for d in range(-3, 4):
                if not groups[d] or not 0 <= z + d < D:
                    continue
                staged = planes[z + d]
                assert staged["phi"][0] == z + d
                for _, dy, dx in groups[d]:
                    ph, ok = t.gather(staged["phi"][1], dy, dx)
                    gn, _ = t.gather(staged["g"][1], dy, dx)
                    lg = torch.clamp((th * ph).sum(-1), min=0.0) * rs
                    up = ok & (lg > m)
                    sc = torch.where(up, torch.exp(m - lg), torch.ones_like(m))
                    den, acc = den * sc, acc * sc[:, None]
                    m = torch.where(up, lg, m)
                    e = torch.where(ok, torch.exp(lg - m),
                                    torch.zeros_like(m))
                    den = den + e
                    acc = acc + torch.where(ok[:, None], e[:, None] * gn,
                                            torch.zeros_like(gn))
            out[z, t.y, t.x] = (acc / torch.clamp(den, min=1e-12)[:, None])[
                :, :G]
            count[z, t.y, t.x] += 1

        Ring(p, tile, D, t.staged({"phi": phi, "g": g}), offsets, 1).run(
            compute)
    assert (count == 1).all()
    return out


def emulate_bwd(theta, phi, g, ybar, scal, offsets, plan):
    """stencil_attention_bwd_plus_kernel and _minus_kernel on one batch
    element: the +o side from the staged phi and g of j + o, the -o side
    from the staged theta, ybar and statistics of i = j - o."""
    D, H, W, F = theta.shape
    G = g.shape[-1]
    groups = dz_groups(offsets)
    dtheta, dphi, dg = (torch.full_like(v, np.nan) for v in (theta, phi, g))
    for side, sgn in (("plus", 1), ("minus", -1)):
        p = plan[side]
        count = torch.zeros((D, H, W), dtype=torch.int32)
        for tile in tiles_of(p, D, H, W):
            t = Tile(tile, p, D, H, W)
            vols = {"phi": phi, "g": g} if side == "plus" else \
                {"theta": theta, "ybar": ybar, "scal": scal}

            def compute(z, planes):
                n = len(t.y)
                if side == "plus":
                    tc, yc = pad4(theta[z, t.y, t.x]), pad4(ybar[z, t.y, t.x])
                    r, m, den, c = scal[z, t.y, t.x].unbind(-1)
                    inv = 1.0 / torch.clamp(den, min=1e-12)
                    acc = torch.zeros(n, tc.shape[-1], dtype=theta.dtype)
                else:
                    pc, gc = pad4(phi[z, t.y, t.x]), pad4(g[z, t.y, t.x])
                    aph = torch.zeros(n, pc.shape[-1], dtype=phi.dtype)
                    ag = torch.zeros(n, gc.shape[-1], dtype=g.dtype)
                for d in range(-3, 4):
                    pl = z + sgn * d
                    if not groups[d] or not 0 <= pl < D:
                        continue
                    st = planes[pl]
                    for _, dy, dx in groups[d]:
                        if side == "plus":
                            pn, ok = t.gather(st["phi"][1], dy, dx)
                            gn, _ = t.gather(st["g"][1], dy, dx)
                            s = (tc * pn).sum(-1)
                            use = ok & (s > 0)
                            a = torch.exp(s * r - m) * inv
                            ds = a * ((yc * gn).sum(-1) - c) * r
                            acc = acc + torch.where(use[:, None],
                                                    ds[:, None] * pn, 0.0)
                        else:
                            ti, ok = t.gather(st["theta"][1], -dy, -dx)
                            yi, _ = t.gather(st["ybar"][1], -dy, -dx)
                            si, _ = t.gather(st["scal"][1], -dy, -dx)
                            s2 = (ti * pc).sum(-1)
                            a2 = torch.exp(torch.clamp(s2, min=0.0)
                                           * si[:, 0] - si[:, 1]) \
                                / torch.clamp(si[:, 2], min=1e-12)
                            ag = ag + torch.where(ok[:, None],
                                                  a2[:, None] * yi, 0.0)
                            ds2 = a2 * ((yi * gc).sum(-1) - si[:, 3]) \
                                * si[:, 0]
                            aph = aph + torch.where((ok & (s2 > 0))[:, None],
                                                    ds2[:, None] * ti, 0.0)
                if side == "plus":
                    dtheta[z, t.y, t.x] = acc[:, :F]
                else:
                    dphi[z, t.y, t.x] = aph[:, :F]
                    dg[z, t.y, t.x] = ag[:, :G]
                count[z, t.y, t.x] += 1

            Ring(p, tile, D, t.staged(vols), offsets, sgn).run(compute)
        assert (count == 1).all()
    return dtheta, dphi, dg


def test_k5_stencils_are_asymmetric():
    for offs in (K5, VARIANT_A):
        assert any((-a, -b, -c) not in offs for a, b, c in offs)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_emulated_fwd_equals_plain(case):
    (D, H, W), F, G, runs, sets, reload = CASES[case]
    offs = case_offsets(case)
    theta, phi, g = volumes((D, H, W), case, (F, F, G))
    p = wa.generic_fwd_plan(1, D, H, W, F, G, wa.generic_halo(offs),
                            runs=runs, sets=sets, reload=reload)
    got = emulate_fwd(theta, phi, g, offs, p)
    want = wa.stencil_attention_plain(theta[None], phi[None], g[None],
                                      offs)[0]
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5 * want.abs().max())


@pytest.mark.parametrize("case", range(len(CASES)))
def test_emulated_bwd_equals_plain(case):
    (D, H, W), F, G, runs, sets, reload = CASES[case]
    offs = case_offsets(case)
    theta, phi, g, ybar = volumes((D, H, W), 10 + case, (F, F, G, G))
    args = (theta[None], phi[None], g[None], ybar[None])
    scal = wa.stencil_attention_scal_plain(*args, offs)
    plan = wa.generic_bwd_plan(1, D, H, W, F, G, wa.generic_halo(offs),
                               runs=runs, sets=sets, reload=reload)
    got = emulate_bwd(theta, phi, g, ybar, scal[0], offs, plan)
    want = wa.stencil_attention_bwd_plain(*args, scal, offs)
    for a, b in zip(got, want):
        assert torch.allclose(a, b[0], rtol=1e-5, atol=1e-5 * b.abs().max())

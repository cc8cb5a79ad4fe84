"""The plane-ring statistics pass of the generic stencil attention
(csrc/stencil_attention_generic.cu:stencil_attention_scal_generic_kernel)
on the CPU: its plan (kernels/window_attention.py:generic_scal_plan)
covers every voxel once with the forward's staged voxel and a launch
vector the launcher takes; a copy of the kernel's tile-by-tile arithmetic
(phi and g staged plane by plane, theta and ybar of the voxel, the
offsets dz group by dz group in the kernel's order, one online softmax
whose numerator takes the denominator's rescale, the degree from
coordinates, out-of-volume edges reading the voxel's own slot and adding
0) equals stencil_attention_scal_plain, also at widths off a multiple
of 4 through the wrappers' zero padding; the same copy with the
numerator not rescaled does not. Keep this copy in step with the .cu."""

import itertools

import numpy as np
import pytest
import torch

from _torch_port_generic_ring import (CASES, VARIANT_A, Ring, Tile,
                                      case_offsets, covers_once, dz_groups,
                                      pad4, plan_ok, tiles_of, volumes)
from dram_tpu_torch.kernels import window_attention as wa


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of small tensor operations: one thread each, so that the
    emulation does not contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def emulate_scal(theta, phi, g, ybar, offsets, p, rescale_num=True):
    """stencil_attention_scal_generic_kernel on one batch element: per
    tile and plane, theta and ybar of the voxel and the offsets dz group
    by dz group from the staged phi and g. The online softmax: a running
    maximum m from 0; each edge's logit l takes mn = max(m, l), scales the
    denominator and the numerator sum e u by exp(m - mn) (1 where the
    maximum stays) and adds e = exp(l - mn). (r, m, denom, num / denom)
    a voxel. `rescale_num=False`: the numerator keeps its scale (a
    fault)."""
    D, H, W, _ = theta.shape
    out = torch.full((D, H, W, 4), np.nan, dtype=theta.dtype)
    count = torch.zeros((D, H, W), dtype=torch.int32)
    groups = dz_groups(offsets)
    K, h = len(offsets), p["halo"]
    for tile in tiles_of(p, D, H, W):
        t = Tile(tile, p, D, H, W)

        def compute(z, planes):
            tc, yc = pad4(theta[z, t.y, t.x]), pad4(ybar[z, t.y, t.x])
            # the degree from coordinates: K where the voxel is h or more
            # from every face, else counted
            counted = torch.zeros_like(t.y)
            for dz, dy, dx in offsets:
                counted += ((0 <= z + dz < D) & (t.y + dy >= 0)
                            & (t.y + dy < H) & (t.x + dx >= 0)
                            & (t.x + dx < W)).long()
            inner = (h <= z < D - h) & (t.y >= h) & (t.y < H - h) \
                & (t.x >= h) & (t.x < W - h)
            assert (counted[inner] == K).all()
            deg = torch.where(inner, K, counted)
            r = torch.rsqrt(torch.clamp(deg.to(theta.dtype), min=1.0))
            m, den, num = (torch.zeros_like(r) for _ in range(3))
            for d in range(-3, 4):
                if not groups[d] or not 0 <= z + d < D:
                    continue
                staged = planes[z + d]
                assert staged["phi"][0] == z + d
                for _, dy, dx in groups[d]:
                    pn, ok = t.gather(staged["phi"][1], dy, dx, own=True)
                    gn, _ = t.gather(staged["g"][1], dy, dx, own=True)
                    lg = torch.where(
                        ok, torch.clamp((tc * pn).sum(-1), min=0.0) * r, 0.0)
                    u = (yc * gn).sum(-1)
                    mn = torch.maximum(m, lg)
                    sc = torch.exp(m - mn)
                    e = torch.where(ok, torch.exp(lg - mn), 0.0)
                    den = den * sc + e
                    num = (num * sc if rescale_num else num) + e * u
                    m = mn
            out[z, t.y, t.x] = torch.stack(
                [r, m, den, num / torch.clamp(den, min=1e-12)], dim=-1)
            count[z, t.y, t.x] += 1

        Ring(p, tile, D, t.staged({"phi": phi, "g": g}), offsets, 1).run(
            compute)
    assert (count == 1).all()
    return out


def _plain(theta, phi, g, ybar, offs):
    return wa.stencil_attention_scal_plain(theta[None], phi[None], g[None],
                                           ybar[None], offs)[0]


def _close(got, want):
    """Each of the four channels within 1e-9 of its largest value (the
    float64 sums change order only)."""
    return all(torch.allclose(a, b, rtol=1e-9, atol=1e-9 * b.abs().max())
               for a, b in zip(got.unbind(-1), want.unbind(-1)))


def test_scal_plan_covers_each_voxel_once():
    """Variant A's step shape, ragged grids and a grid narrower than a
    tile, at every halo and widths 1 to 64: the plan covers each voxel
    once; its staged voxel is the forward's (phi and g, padded to a
    multiple of 4); its launch vector passes the launchers' plan_ok at
    that voxel and fails at the -o side's (the statistics too)."""
    grids = [(10, 64, 64, 64), (2, 37, 45, 53), (1, 3, 5, 6), (2, 1, 1, 1)]
    widths = [(1, 1), (5, 3), (16, 4), (33, 1), (64, 64)]
    for (B, D, H, W), (F, G), h in itertools.product(grids, widths, range(4)):
        p = wa.generic_scal_plan(B, D, H, W, F, G, h)
        covers_once(p, B, D, H, W)
        lanes = wa.generic_class(F, G)[0]
        assert p["kind"] == "scal" and p["halo"] == h and p["lanes"] == lanes
        vox = wa.generic_voxel("scal", F, G)
        assert vox == wa.generic_voxel("fwd", F, G) == 4 * (
            -(-F // 4) + -(-G // 4))
        assert plan_ok(p["args"], B, D, H, W, h, lanes, vox)
        assert not plan_ok(p["args"], B, D, H, W, h, lanes, vox + 4)
        assert not plan_ok(p["args"], B, D + p["run"][0], H, W, h,
                           lanes, vox)
    # variant A's step: the forward's whole ring and tile
    a = wa.generic_scal_plan(10, 64, 64, 64, 16, 4, 2)
    assert a["reload"] == 0 and a["run"] == wa.GENERIC_RUNS["scal"]
    assert a["sets"] == wa.GENERIC_SETS["scal"] and a["nbuf"] == 5 + a["sets"]
    # F = G = 64 at halo 3 takes the reload ring, as the forward
    wide = wa.generic_scal_plan(2, 64, 64, 64, 64, 64, 3)
    assert wide["reload"] == 1 and wide["lanes"] == 4
    assert wide["args"] == wa.generic_fwd_plan(2, 64, 64, 64, 64, 64, 3,
                                               runs=wide["run"], reload=1)[
        "args"]
    p = dict(wa.generic_scal_plan(2, 37, 45, 53, 16, 4, 2))
    for key, val in (("tiles", (p["tiles"][0] - 1, *p["tiles"][1:])),
                     ("cols", p["cols"] - 1), ("smem", p["smem"] + 16)):
        with pytest.raises(ValueError):
            wa._generic_check(dict(p, **{key: val}), 2, 37, 45, 53, 16, 4)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_emulated_scal_equals_plain(case):
    """The plan test's cases: ragged grids, the asymmetric k = 5
    stencils, one to three sets, the whole and the reload ring."""
    (D, H, W), F, G, runs, sets, reload = CASES[case]
    offs = case_offsets(case)
    theta, phi, g, ybar = volumes((D, H, W), 20 + case, (F, F, G, G))
    p = wa.generic_scal_plan(1, D, H, W, F, G, wa.generic_halo(offs),
                             runs=runs, sets=sets, reload=reload)
    got = emulate_scal(theta, phi, g, ybar, offs, p)
    want = _plain(theta, phi, g, ybar, offs)
    assert _close(got, want)
    # m is the exact maximum; r the exact degree
    assert torch.equal(got[..., 0], want[..., 0])
    assert torch.equal(got[..., 1], want[..., 1])


def test_emulated_scal_on_variant_a_plan():
    """Variant A's stencil and widths on the plan the wrapper takes
    (GENERIC_RUNS["scal"] clipped to the grid, its sets), a grid with
    voxels h or more from every face."""
    D, H, W = 9, 10, 12
    theta, phi, g, ybar = volumes((D, H, W), 30, (16, 16, 4, 4))
    p = wa.generic_scal_plan(1, D, H, W, 16, 4, 2)
    got = emulate_scal(theta, phi, g, ybar, VARIANT_A, p)
    assert _close(got, _plain(theta, phi, g, ybar, VARIANT_A))


@pytest.mark.parametrize("widths", [(5, 3), (33, 1)])
def test_padded_widths_give_the_same_scal(widths):
    """Widths off a multiple of 4 run on zero-padded channels: the
    statistics of the padded operands are those of the operands, and the
    emulation (which stages padded rows) equals the plain version."""
    F, G = widths
    D, H, W = 5, 6, 7
    offs = case_offsets(1)
    theta, phi, g, ybar = volumes((D, H, W), 40 + F, (F, F, G, G))
    want = _plain(theta, phi, g, ybar, offs)
    padded = _plain(*(wa._pad4(t) for t in (theta, phi, g, ybar)), offs)
    assert wa._pad4(theta).shape[-1] == 4 * -(-F // 4)
    assert _close(padded, want)
    p = wa.generic_scal_plan(1, D, H, W, F, G, wa.generic_halo(offs))
    assert p["lanes"] == wa.generic_class(F, G)[0]
    assert _close(emulate_scal(theta, phi, g, ybar, offs, p), want)
    # CPU tensors take the plain version
    got = wa.stencil_attention_scal_generic(theta[None].float(),
                                            phi[None].float(),
                                            g[None].float(),
                                            ybar[None].float(), offs)[0]
    assert torch.equal(got, _plain(*(t.float() for t in (
        theta, phi, g, ybar)), offs))


def test_numerator_not_rescaled_differs():
    """The emulation can fail: with the numerator left at its scale when
    the maximum grows, c leaves the plain version, while r, m and the
    denominator stay."""
    (D, H, W), F, G, runs, sets, reload = CASES[0]
    offs = case_offsets(0)
    theta, phi, g, ybar = volumes((D, H, W), 20, (F, F, G, G))
    p = wa.generic_scal_plan(1, D, H, W, F, G, wa.generic_halo(offs),
                             runs=runs, sets=sets, reload=reload)
    got = emulate_scal(theta, phi, g, ybar, offs, p, rescale_num=False)
    want = _plain(theta, phi, g, ybar, offs)
    assert _close(got[..., :3], want[..., :3])
    c, cw = got[..., 3], want[..., 3]
    assert (c - cw).abs().max() > 1e-2 * cw.abs().max()

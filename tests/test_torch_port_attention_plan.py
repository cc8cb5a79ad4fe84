"""The tile plans of csrc/stencil_attention.cu's forward and gradient pass
(kernels/window_attention.py:fwd_plan, bwd_plan), emulated on the CPU at
every attention launch of the flagship (64^3, batch 5 for a scan, 10 for
a training step, 2 for the training golden) and on odd grids: a copy of
the kernels' in-tile arithmetic (the staged spans clipped at the volume,
the bulk copies of each plane and the bytes announced on its mbarrier,
the producer's plane ring and the compute warps' releases, validity and
degree from coordinates, the gathered neighbours) run tile by tile on
the staged copies only, and held against
stencil_attention_plain / stencil_attention_bwd_plain. Each voxel is
written exactly once. The plan is the launch's (real batch); the
emulated data is one batch element, since a tile's arithmetic is the
same for every batch element. Keep this copy in step with the .cu
file."""

import functools

import numpy as np
import pytest
import torch

from dram_tpu_torch.kernels import window_attention as wa


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulation is thousands of small tensor operations: one thread
    each, so that it does not contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

OFFSETS = wa.KERNEL_OFFSETS
# floats a staged voxel holds per operand, in buffer order
FWD_OPS = ("phi", "g", "theta")
BWD_OPS = ("phi", "g", "theta", "ybar", "scal")
VF = {"phi": 8, "g": 8, "theta": 8, "ybar": 8, "scal": 4}


def halo_span(n, a, b):
    """[first, last] of an axis of n that a tile's run [a, b) stages: the
    run and one on each side, clipped to the axis (the kernels' tile_of)."""
    return max(a - 1, 0), min(b, n - 1)


def _vols(shape, seed, n):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            for _ in range(n)]


def _tiles(plan, D, H, W):
    zr, yr, xr = plan["run"]
    tx, ty, tz = plan["tiles"]
    for z in range(tz):
        for y in range(ty):
            for x in range(tx):
                yield ((z * zr, min(z * zr + zr, D)),
                       (y * yr, min(y * yr + yr, H)),
                       (x * xr, min(x * xr + xr, W)))


def _copies(plan, B, D, H, W, ops, pl, ry0, ry1, cx0, ncols):
    """csrc/stencil_attention.cu:stage_plane for plane pl of the last
    batch element: every bulk copy stays inside its tensor and its
    operand's part of the buffer, and their bytes are those announced."""
    whole = ncols == W
    offs, total = {}, 0
    for o in ops:
        offs[o] = total
        total += plan["rows"] * plan["cols"] * VF[o]
    announced = sum(ncols * VF[o] * 4 for o in ops) * (ry1 - ry0 + 1)
    copied = 0
    for o in ops:
        vf = VF[o]
        starts = [ry0] if whole else list(range(ry0, ry1 + 1))
        nr = ry1 - ry0 + 1 if whole else 1
        for r in starts:
            src = (((B - 1) * D + pl) * H + r) * W + cx0
            assert 0 <= src and (src + nr * ncols) <= B * D * H * W
            dst = (r - ry0) * ncols * vf
            assert dst + nr * ncols * vf <= plan["rows"] * plan["cols"] * vf
            copied += nr * ncols * vf * 4
    assert copied == announced


class Ring:
    """The plane ring of one tile: nbuf buffers, plane pl in buffer
    (pl - pz0) % nbuf. The producer warp stages the planes in order, each
    once the plane its buffer held has been released; the compute warps
    release plane z - 1 when done with plane z."""

    def __init__(self, plan, vols, ops, tile, dims, fill):
        self.plan, self.vols, self.ops, self.fill = plan, vols, ops, fill
        (za, zb), (ya, yb), (xa, xb) = tile
        self.D, self.H, self.W, self.B = dims
        self.pz0, self.pz1 = halo_span(self.D, za, zb)
        self.ry0, self.ry1 = halo_span(self.H, ya, yb)
        self.cx0, self.cx1 = halo_span(self.W, xa, xb)
        self.ncols = self.cx1 - self.cx0 + 1
        assert self.ry1 - self.ry0 + 1 <= plan["rows"]
        assert self.ncols <= plan["cols"]
        self.held = [None] * plan["nbuf"]
        self.data = [None] * plan["nbuf"]
        self.released = set()
        self.next = self.pz0
        self._produce()

    def _produce(self):
        """Stage every plane whose buffer is free, in order."""
        nbuf = self.plan["nbuf"]
        while self.next <= self.pz1 and (self.next - self.pz0 < nbuf or (
                self.next - nbuf) in self.released):
            self._load(self.next)
            self.next += 1

    def _load(self, pl):
        s = (pl - self.pz0) % self.plan["nbuf"]
        _copies(self.plan, self.B, self.D, self.H, self.W, self.ops, pl,
                self.ry0, self.ry1, self.cx0, self.ncols)
        self.held[s] = pl
        ys, xs = slice(self.ry0, self.ry1 + 1), slice(self.cx0,
                                                      self.cx1 + 1)
        if self.fill is None:
            self.data[s] = {o: self.vols[o][pl, ys, xs] for o in self.ops}
        else:
            # the faulty alternative: slots outside the volume hold `fill`
            # (a one-voxel border around the span) and are read
            self.data[s] = {o: torch.nn.functional.pad(
                self.vols[o], (0, 0, 1, 1, 1, 1, 1, 1), value=self.fill)[
                    pl + 1, self.ry0:self.ry1 + 3, self.cx0:self.cx1 + 3]
                for o in self.ops}

    def step(self, z):
        """Plane z is about to be computed: z - 1 .. z + 1 are staged."""
        for pl in range(max(z - 1, self.pz0), min(z + 1, self.pz1) + 1):
            assert self.held[(pl - self.pz0) % self.plan["nbuf"]] == pl

    def done(self, z):
        """Every compute warp is done with plane z: plane z - 1 is free."""
        if z - 1 >= self.pz0:
            self.released.add(z - 1)
        self._produce()

    def plane(self, pl):
        """The staged copy of plane pl; assert it is the ring's. A plane
        outside the volume is never staged: the kernels never read it
        (with a `fill`, it reads as that value)."""
        if not 0 <= pl < self.D:
            return None if self.fill is None else {
                o: torch.full_like(v, self.fill)
                for o, v in self.data[0].items()}
        s = (pl - self.pz0) % self.plan["nbuf"]
        assert self.held[s] == pl
        return self.data[s]

    def planes(self, z):
        """Per operand, the staged planes z - 1, z, z + 1 stacked (a plane
        outside the volume as NaN, which a masked read never meets)."""
        got = [self.plane(z + d) for d in (-1, 0, 1)]
        return {o: torch.stack([p[o] if p is not None else
                                torch.full_like(got[1][o], float("nan"))
                                for p in got]) for o in self.ops}

    def gather(self, stack, op, dz, y, x):
        """stack[op] at planes z + dz, rows y, columns x (global), from
        the staged copies; indices outside them are clamped (the caller
        masks them)."""
        t = stack[op]
        off = 0 if self.fill is None else 1
        ly = torch.clamp(y - self.ry0 + off, 0, t.shape[1] - 1)
        lx = torch.clamp(x - self.cx0 + off, 0, t.shape[2] - 1)
        return t[dz + 1, ly, lx]


def _coords(tile, H, W):
    (_, _), (ya, yb), (xa, xb) = tile
    y, x = torch.meshgrid(torch.arange(ya, yb), torch.arange(xa, xb),
                          indexing="ij")
    return y.reshape(-1), x.reshape(-1)


def _stencil(z, y, x, offsets, D, H, W, fill):
    """Per offset o (rows) and voxel (columns): the plane step dz, the
    neighbour's row and column, and its validity from coordinates (every
    slot is read, valid, with a `fill`); and the voxels' degree."""
    o = torch.tensor(offsets)
    dz, ny, nx = o[:, 0:1], y[None] + o[:, 1:2], x[None] + o[:, 2:3]
    valid = (z + dz >= 0) & (z + dz < D) & (ny >= 0) & (ny < H) \
        & (nx >= 0) & (nx < W)
    deg = valid.sum(0)
    if fill is not None:
        valid = torch.ones_like(valid)
    return dz.expand_as(ny), ny, nx, valid, deg


def emulate_fwd(theta, phi, g, plan, B, fill=None):
    """csrc/stencil_attention.cu's forward, tile by tile, on (D, H, W, 8)
    operands of one batch element: per plane, the softmax over the valid
    neighbours read from the staged planes (the kernel streams it in its
    offset order; the same sums up to rounding). With a `fill`,
    out-of-volume slots hold that value and are read instead of masked."""
    D, H, W, _ = theta.shape
    vols = {"phi": phi, "g": g, "theta": theta}
    out = torch.zeros_like(g)
    count = torch.zeros((D, H, W), dtype=torch.int32)
    for tile in _tiles(plan, D, H, W):
        ring = Ring(plan, vols, FWD_OPS, tile, (D, H, W, B), fill)
        y, x = _coords(tile, H, W)
        for z in range(*tile[0]):
            ring.step(z)
            stack = ring.planes(z)
            ring.done(z)
            dz, ny, nx, valid, deg = _stencil(z, y, x, OFFSETS, D, H, W,
                                              fill)
            rs = torch.rsqrt(torch.clamp(deg.float(), min=1.0))
            ph = ring.gather(stack, "phi", dz, ny, nx)
            gj = ring.gather(stack, "g", dz, ny, nx)
            th = ring.gather(stack, "theta", torch.zeros_like(y), y, x)
            s = torch.clamp((th[None] * ph).sum(-1), min=0.0) * rs
            s = torch.where(valid, s, torch.tensor(float("-inf")))
            m = torch.clamp(s.amax(0), min=0.0)
            e = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
            acc = torch.where(valid[..., None], e[..., None] * gj,
                              torch.zeros_like(gj)).sum(0)
            out[z, y, x] = acc / torch.clamp(e.sum(0), min=1e-12)[:, None]
            count[z, y, x] += 1
    assert (count == 1).all()
    return out


def emulate_bwd(theta, phi, g, ybar, scal, plan, B, fill=None):
    """csrc/stencil_attention.cu's gradient pass, tile by tile: the +o
    side from the staged phi and g, the -o side from the staged theta,
    ybar and statistics of i = v - o, the validity of i's edge from
    coordinates; own values from the staged centre plane."""
    D, H, W, _ = theta.shape
    vols = {"phi": phi, "g": g, "theta": theta, "ybar": ybar, "scal": scal}
    neg = [(-dz, -dy, -dx) for dz, dy, dx in OFFSETS]
    grads = [torch.zeros_like(t) for t in (theta, phi, g)]
    count = torch.zeros((D, H, W), dtype=torch.int32)
    for tile in _tiles(plan, D, H, W):
        ring = Ring(plan, vols, BWD_OPS, tile, (D, H, W, B), fill)
        y, x = _coords(tile, H, W)
        for z in range(*tile[0]):
            ring.step(z)
            stack = ring.planes(z)
            ring.done(z)
            zero = torch.zeros_like(y)
            ph, gv, th, yb, sv = (ring.gather(stack, o, zero, y, x)
                                  for o in BWD_OPS)
            rv, mv, cv = sv[:, 0], sv[:, 1], sv[:, 3]
            dv = torch.clamp(sv[:, 2], min=1e-12)
            # +o side: v's softmax over its neighbours n = v + o
            dz, ny, nx, vp, _ = _stencil(z, y, x, OFFSETS, D, H, W, fill)
            pn = ring.gather(stack, "phi", dz, ny, nx)
            gn = ring.gather(stack, "g", dz, ny, nx)
            sp = (th[None] * pn).sum(-1)
            a = torch.exp(torch.clamp(sp, min=0.0) * rv - mv) / dv
            ds = torch.where(vp & (sp > 0),
                             a * ((yb[None] * gn).sum(-1) - cv) * rv, 0.0)
            dth = (ds[..., None] * torch.where(vp[..., None], pn, 0.0)).sum(0)
            # -o side: the softmaxes of i = v - o
            dz, iy, ix, vm, _ = _stencil(z, y, x, neg, D, H, W, fill)
            ti = ring.gather(stack, "theta", dz, iy, ix)
            yi = ring.gather(stack, "ybar", dz, iy, ix)
            si = ring.gather(stack, "scal", dz, iy, ix)
            s2 = (ti * ph[None]).sum(-1)
            a2 = torch.exp(torch.clamp(s2, min=0.0) * si[..., 0]
                           - si[..., 1]) / torch.clamp(si[..., 2], min=1e-12)
            ds2 = torch.where(vm & (s2 > 0), a2 * (
                (yi * gv[None]).sum(-1) - si[..., 3]) * si[..., 0], 0.0)
            a2 = torch.where(vm, a2, 0.0)
            dph = (ds2[..., None] * torch.where(vm[..., None], ti, 0.0)) \
                .sum(0)
            dgv = (a2[..., None] * torch.where(vm[..., None], yi, 0.0)).sum(0)
            for t, d in zip(grads, (dth, dph, dgv)):
                t[z, y, x] = d
            count[z, y, x] += 1
    assert (count == 1).all()
    return tuple(grads)


def _scal(theta, phi, g, ybar):
    return wa.stencil_attention_scal_plain(
        theta[None], phi[None], g[None], ybar[None])[0]


@functools.lru_cache(maxsize=4)
def _emulated_64(args, bwd):
    """The emulation of one plan (its `args`) at 64^3 and the plain
    version's result; launches that share a plan share it."""
    plan = (wa.bwd_plan if bwd else wa.fwd_plan)(
        1, 64, 64, 64, runs=tuple(args[:3]), nbuf=args[8])
    vols = _vols((64, 64, 64, 8), 11, 4)
    if not bwd:
        theta, phi, g, _ = vols
        return (emulate_fwd(theta, phi, g, plan, 1),), (
            wa.stencil_attention_plain(theta[None], phi[None], g[None])[0],)
    scal = _scal(*vols)
    got = emulate_bwd(*vols, scal, plan, 1)
    want = wa.stencil_attention_bwd_plain(*(v[None] for v in vols),
                                          scal[None])
    return got, tuple(w[0] for w in want)


@pytest.mark.parametrize("B", [5, 10, 2])
def test_fwd_plan_emulated_64(B):
    plan = wa.fwd_plan(B, 64, 64, 64)
    assert plan["threads"] <= wa.FWD_THREADS
    assert plan["smem"] <= wa.SMEM_BLOCK
    for a, b in zip(*_emulated_64(plan["args"], False)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B", [10, 2])
def test_bwd_plan_emulated_64(B):
    plan = wa.bwd_plan(B, 64, 64, 64)
    assert plan["threads"] <= wa.BWD_THREADS
    assert plan["smem"] <= wa.SMEM_BLOCK
    for a, b in zip(*_emulated_64(plan["args"], True)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# odd and uneven grids: (D, H, W), forced runs (or None: the plan's
# search) and ring depths; runs that do not divide D or H, one-voxel
# axes, column tiles with a +-1 column halo
ODD = [((5, 7, 9), None, 4), ((1, 1, 1), None, 4), ((7, 6, 20), (3, 4, 8), 3),
       ((9, 5, 16), (4, 2, 16), 5), ((6, 9, 5), (6, 4, 5), 4),
       ((3, 2, 33), (2, 1, 16), 4)]


@pytest.mark.parametrize("shape,runs,nbuf", ODD)
def test_odd_grids_emulated(shape, runs, nbuf):
    D, H, W = shape
    theta, phi, g, ybar = _vols((D, H, W, 8), D * H * W, 4)
    fp = wa.fwd_plan(2, D, H, W, runs=runs, nbuf=nbuf)
    torch.testing.assert_close(
        emulate_fwd(theta, phi, g, fp, 2),
        wa.stencil_attention_plain(theta[None], phi[None], g[None])[0],
        rtol=1e-5, atol=1e-5)
    bp = wa.bwd_plan(2, D, H, W, runs=runs, nbuf=nbuf)
    scal = _scal(theta, phi, g, ybar)
    got = emulate_bwd(theta, phi, g, ybar, scal, bp, 2)
    want = wa.stencil_attention_bwd_plain(
        theta[None], phi[None], g[None], ybar[None], scal[None])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b[0], rtol=1e-5, atol=1e-5)


def test_zero_fill_is_not_padding():
    """An out-of-volume neighbour read as zeros still enters the forward's
    softmax (logit relu(theta . 0) r = 0, weight exp(-m)): filling the
    slots with zeros instead of masking them changes every face voxel and
    leaves the interior as it is. In the gradient pass every term a
    neighbour adds carries a factor of its own zeros, so zeros there are
    harmless, but a slot that is not copied holds stale data (here ones),
    which moves dtheta, dphi and dg at the faces: the kernels mask both."""
    D = H = W = 6
    theta, phi, g, ybar = _vols((D, H, W, 8), 7, 4)
    fp = wa.fwd_plan(1, D, H, W, runs=(3, 2, 6))
    bp = wa.bwd_plan(1, D, H, W, runs=(3, 2, 6))
    face = torch.ones((D, H, W), dtype=torch.bool)
    face[1:-1, 1:-1, 1:-1] = False
    sound = emulate_fwd(theta, phi, g, fp, 1)
    diff = (sound - emulate_fwd(theta, phi, g, fp, 1, fill=0.0)).abs() \
        .amax(-1)
    assert diff[~face].max() == 0
    assert (diff[face] > 1e-4).all()
    scal = _scal(theta, phi, g, ybar)
    sound = emulate_bwd(theta, phi, g, ybar, scal, bp, 1)
    zeros = emulate_bwd(theta, phi, g, ybar, scal, bp, 1, fill=0.0)
    stale = emulate_bwd(theta, phi, g, ybar, scal, bp, 1, fill=1.0)
    for k in range(3):
        torch.testing.assert_close(zeros[k], sound[k], rtol=0, atol=0)
        diff = (sound[k] - stale[k]).abs().amax(-1)
        assert diff[~face].max() == 0
        assert diff[face].max() > 1e-3


@pytest.mark.parametrize("bwd", [False, True])
def test_uncovering_plan_raises(bwd):
    plan = (wa.bwd_plan if bwd else wa.fwd_plan)(10, 64, 64, 64)
    tx, ty, tz = plan["tiles"]
    for tiles in ((tx - 1, ty, tz), (tx, ty - 1, tz), (tx, ty, tz - 1)):
        with pytest.raises(ValueError, match="uncovered"):
            wa._check(dict(plan, tiles=tiles), 10, 64, 64, 64, bwd)
    for change in ({"rows": plan["rows"] - 1}, {"nbuf": 2},
                   {"smem": plan["smem"] - 16}):
        with pytest.raises(ValueError, match="buffers"):
            wa._check(dict(plan, **change), 10, 64, 64, 64, bwd)
    with pytest.raises(ValueError, match="block too large"):
        (wa.bwd_plan if bwd else wa.fwd_plan)(10, 64, 64, 64,
                                              runs=(8, 16, 64))

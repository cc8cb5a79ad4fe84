"""The plane ring of the generic stencil-attention kernels
(csrc/stencil_generic_ring.cuh) emulated on the CPU, shared by the tests
of its forward and gradient pass (tests/test_torch_port_generic_plan.py)
and of its statistics pass (tests/test_torch_port_generic_scal.py): the
tiles of a plan, the ring's protocol run as a schedule of its actors
(the producer and each set's warps), a tile's staged boxes, and the
stencils, widths and plans the emulations are held at. Keep it in step
with the .cuh."""

import itertools

import numpy as np
import torch

from dram_tpu_torch.kernels import window_attention as wa

SMEM_BLOCK = 227 * 1024
VARIANT_A = wa.stencil_offsets(5, 2, True)  # 98 offsets, halo 2
# one offset list of each halo, and K = 1 and 343
STENCILS = {0: ((0, 0, 0),), 1: wa.stencil_offsets(3, 1, True),
            2: VARIANT_A, 3: wa.stencil_offsets(7, 3, True)}
# the asymmetric k = 5 stencils (some o in the stencil, -o not), a ragged
# grid, and plans of several tiles, sets and both ring kinds
K5 = wa.stencil_offsets(5, 1, True)
CASES = [  # (grid, F, G, runs, sets, reload)
    ((7, 9, 11), 16, 4, (3, 4, 8), 2, 0),
    ((6, 5, 10), 5, 3, (4, 2, 8), 3, 0),
    ((5, 6, 7), 8, 8, (2, 3, 4), 1, 1),
]


def case_offsets(case):
    """The stencil of CASES[case]: variant A's for the first, k = 5
    connectivity 1 for the others."""
    return VARIANT_A if case == 0 else K5


def plan_ok(args, B, D, H, W, h, lanes, vox):
    """csrc/stencil_generic_ring.cuh:plan_ok, the launchers' check of a
    plan's launch vector (sg::Plan's fields in order) for a grid, halo,
    lanes a voxel and `vox` staged floats a voxel."""
    (zr, yr, xr, tx, ty, tz, rows, cols, nbuf, sets, reload, threads, smem,
     ph, pl) = args
    if min(zr, yr, xr) < 1 or ph != h or pl != lanes:
        return False
    if tx * xr < W or ty * yr < H or tz * zr < D or (tx - 1) * xr >= W \
            or (ty - 1) * yr >= H or (tz - 1) * zr >= D \
            or B * tx * ty * tz >= 1 << 31:
        return False
    if rows != min(yr + 2 * h, H) or cols != min(xr + 2 * h, W):
        return False
    if reload == 1:
        if sets != 1 or not 2 <= nbuf <= wa.GENERIC_MAX_NBUF:
            return False
    elif reload != 0 or sets < 1 or not 2 * h + sets + 1 <= nbuf \
            <= wa.GENERIC_MAX_NBUF:
        return False
    need = wa.GENERIC_BAR_BYTES + nbuf * rows * cols * vox * 4
    warps = -(-(yr * xr * lanes) // 32)
    return threads == 32 * (sets * warps + 1) \
        and threads <= wa.GENERIC_MAX_THREADS and smem == need \
        and need <= SMEM_BLOCK


def tiles_of(p, D, H, W):
    zr, yr, xr = p["run"]
    tx, ty, tz = p["tiles"]
    for z, y, x in itertools.product(range(tz), range(ty), range(tx)):
        yield ((z * zr, min(z * zr + zr, D)), (y * yr, min(y * yr + yr, H)),
               (x * xr, min(x * xr + xr, W)))


def covers_once(p, B, D, H, W):
    """Every voxel in exactly one tile; the tile's staged box within the
    plan's buffers; the block within the card's limits."""
    count = np.zeros((D, H, W), np.int32)
    h = p["halo"]
    for (za, zb), (ya, yb), (xa, xb) in tiles_of(p, D, H, W):
        assert za < zb and ya < yb and xa < xb
        count[za:zb, ya:yb, xa:xb] += 1
        assert min(yb - 1 + h, H - 1) - max(ya - h, 0) + 1 <= p["rows"]
        assert min(xb - 1 + h, W - 1) - max(xa - h, 0) + 1 <= p["cols"]
    assert (count == 1).all()
    assert p["blocks"] == B * np.prod(p["tiles"])
    assert p["smem"] <= SMEM_BLOCK and p["threads"] <= 512
    assert p["threads"] % 32 == 0


# --- the ring's protocol ------------------------------------------------------


def dz_groups(offsets):
    """The offsets grouped by dz in their order (Stencil::start)."""
    return {d: [o for o in offsets if o[0] == d] for d in range(-3, 4)}


def plane_steps(offsets, z, D, sgn):
    """The (d, plane) steps of plane z that read a staged plane."""
    g = dz_groups(offsets)
    return [(d, z + sgn * d) for d in range(-3, 4)
            if g[d] and 0 <= z + sgn * d < D]


class Ring:
    """csrc/stencil_generic_ring.cuh's ring for one tile, run as a
    schedule of its actors (the producer and each set's warps): whole
    ring or reload. `compute(z, planes)` is called when a set computes
    plane z, with {plane: the staged box} of the planes it reads. Asserts
    that every release arrives in its buffer's phase, that a waited plane
    is the one in its buffer, and that the schedule never deadlocks."""

    def __init__(self, p, tile, D, stage, offsets, sgn):
        (self.za, self.zb), _, _ = tile
        self.p, self.D, self.stage = p, D, stage
        h = p["halo"]
        self.pz0, self.pz1 = max(self.za - h, 0), min(self.zb - 1 + h, D - 1)
        self.offsets, self.sgn = offsets, sgn
        nbuf, sets = p["nbuf"], p["sets"]
        if p["reload"]:
            self.seq = [pl for z in range(self.za, self.zb)
                        for _, pl in plane_steps(offsets, z, D, sgn)]
        else:
            self.seq = list(range(self.pz0, self.pz1 + 1))
        self.held = [None] * nbuf       # staged plane index into seq
        self.data = [None] * nbuf
        self.empty = [set() for _ in range(nbuf)]  # arrivals this phase
        self.done = [0] * nbuf          # completed empty phases
        self.k = 0
        self.sets = [{"z": self.za + s, "rel": self.pz0, "step": 0}
                     for s in range(sets)]

    def _arrive(self, slot, k, who):
        """Set `who` releases the buffer's use by seq[k]: that use must be
        the buffer's current phase."""
        assert k == slot + self.done[slot] * self.p["nbuf"], "phase"
        assert who not in self.empty[slot]
        self.empty[slot].add(who)
        if len(self.empty[slot]) == len(self.sets):
            self.empty[slot] = set()
            self.done[slot] += 1

    def _produce(self):
        nbuf = self.p["nbuf"]
        if self.k < len(self.seq) and (self.k < nbuf or self.done[
                self.k % nbuf] > (self.k - nbuf) // nbuf):
            s = self.k % nbuf
            self.held[s], self.data[s] = self.k, self.stage(self.seq[self.k])
            self.k += 1
            return True
        return False

    def _staged(self, k):
        s = k % self.p["nbuf"]
        return self.held[s] == k

    def _run_set(self, i):
        """One step of set i's warps; whether anything moved."""
        st, p, h = self.sets[i], self.p, self.p["halo"]
        nbuf, z = p["nbuf"], st["z"]
        if z >= self.zb:
            return False
        moved = False
        if p["reload"]:
            # each step's buffer: wait for it, read it, release it
            steps = plane_steps(self.offsets, z, self.D, self.sgn)
            got = st.setdefault("got", {})
            while len(got) < len(steps):
                k = st["step"]
                if not self._staged(k):
                    return moved
                pl = steps[len(got)][1]
                assert self.seq[k] == pl
                got[pl] = self.data[k % nbuf]
                self._arrive(k % nbuf, k, i)
                st["step"], moved = k + 1, True
            self.compute(z, got)
            st["got"] = {}
        else:
            # Ring::enter: wait for z - h .. z + h, then release the planes
            # below z - h
            need = range(max(z - h, self.pz0), min(z + h, self.pz1) + 1)
            if not all(self._staged(pl - self.pz0) for pl in need):
                return False
            upto = min(z - h, self.pz1 + 1)
            for pl in range(st["rel"], upto):
                self._arrive((pl - self.pz0) % nbuf, pl - self.pz0, i)
            st["rel"] = max(st["rel"], upto)
            self.compute(z, {pl: self.data[(pl - self.pz0) % nbuf]
                             for pl in need})
        st["z"] = z + len(self.sets)
        return True

    def run(self, compute, rng=None):
        """Round-robin, or with `rng` one actor at a time in a random
        order (the warps drift)."""
        self.compute = compute
        actors = [self._produce] + [
            (lambda i: lambda: self._run_set(i))(i)
            for i in range(len(self.sets))]
        while any(st["z"] < self.zb for st in self.sets):
            order = actors if rng is None else \
                [actors[i] for i in rng.permutation(len(actors))]
            moved = False
            for act in order:
                moved = act() or moved
                if moved and rng is not None:
                    break
            assert moved, "the ring deadlocked"


def ring_order(p, tile, D, offs, sgn, seed=None):
    """The planes a tile's sets compute, each reading the planes it
    waited for (the staged data here: the plane's index); round-robin, or
    a random schedule of `seed`."""
    seen = []

    def compute(z, planes):
        assert all(pl == got for pl, got in planes.items())
        seen.append(z)
    Ring(p, tile, D, lambda pl: pl, offs, sgn).run(
        compute, None if seed is None else np.random.default_rng(seed))
    return seen


# --- a tile's staged boxes ----------------------------------------------------


def volumes(shape, seed, widths):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(*shape, w)).astype(np.float64))
            for w in widths]


def pad4(t):
    w = t.shape[-1]
    return torch.nn.functional.pad(t, (0, (-w) % 4))


class Tile:
    """One tile's voxels (flattened y, x) and its staged box."""

    def __init__(self, tile, p, D, H, W):
        (self.za, self.zb), (ya, yb), (xa, xb) = tile
        h = p["halo"]
        self.ry0, self.ry1 = max(ya - h, 0), min(yb - 1 + h, H - 1)
        self.cx0, self.cx1 = max(xa - h, 0), min(xb - 1 + h, W - 1)
        y, x = torch.meshgrid(torch.arange(ya, yb), torch.arange(xa, xb),
                              indexing="ij")
        self.y, self.x = y.reshape(-1), x.reshape(-1)
        self.H, self.W = H, W

    def staged(self, vols):
        """The producer's copies of one plane: each operand's rows ry0 ..
        ry1 and columns cx0 .. cx1 (the wrappers pad the channels to a
        multiple of 4)."""
        ys, xs = slice(self.ry0, self.ry1 + 1), slice(self.cx0, self.cx1 + 1)
        return lambda pl: {k: (pl, pad4(v[pl, ys, xs]))
                           for k, v in vols.items()}

    def gather(self, box, dy, dx, own=False):
        """box[y + dy, x + dx] of the staged box and validity from
        coordinates. An invalid slot is never read: it reads as NaN, or
        with `own` the voxel's own slot (the kernels' branch-free edge
        loops read it and add nothing)."""
        ny, nx = self.y + dy, self.x + dx
        ok = (ny >= 0) & (ny < self.H) & (nx >= 0) & (nx < self.W)
        if own:
            ny, nx = torch.where(ok, ny, self.y), torch.where(ok, nx, self.x)
        ly = (ny - self.ry0).clamp(0, box.shape[0] - 1)
        lx = (nx - self.cx0).clamp(0, box.shape[1] - 1)
        got = box[ly, lx]
        if own:
            return got, ok
        return torch.where(ok[:, None], got, torch.full_like(got, np.nan)), ok

"""The network-entry conv's Hopper kernels (csrc/conv3x3x3_c1.cu: the
Ci = 1 forward and weight gradient), rehearsed on the CPU. The kernels
run only on the card; kernels/conv_stack.py decides their launch geometry
(c1_plan, c1_dw_plan) and which launches take them (c1_takes), and those
are the code under test here.

The helpers below are a copy of the kernels' compiled arithmetic: the
tile and box decode, the halo with its zero fill, the tap order and its
K = 32 padding, the permuted weight fragments whose columns the epilogue
stores as 8 consecutive channels, the statistics rows (8 warps added in
order, one row a block), the weight gradient's shifted halo copy and its
split-K partial rows, and colsum_f32's fixed order. In f32 the emulation
must equal the port's plain versions and dram_tpu's Pallas kernels in
interpret mode (rtol 1e-5: the same products summed in another order):
conv_cm on the input 8-padded as models/blocks.py:235-242 pads it (eval
and raw + statistics), conv_dw_cm, and conv3d_pallas at Ci = 1 with its
VJP's dW. A kernel that departs from the copy fails chip_smoke.py's conv
sweep on the card."""

import collections
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dram_tpu.core.pallas.cm import from_cm, to_cm
from dram_tpu.core.pallas.conv3d import conv3d_pallas
from dram_tpu.core.pallas.fused_stack import _wk, conv_cm, conv_dw_cm

from dram_tpu_torch.kernels import _build, conv3d, conv_stack as cs
from dram_tpu_torch.models.dc3d_at import DC3D

BX, BY, BZ = cs.C1_BOX
HX, HY, HZ = BX + 2, BY + 2, BZ + 2
DBX, DBY, DBZ = cs.C1_DW_BOX
DHX, DHY, DHZ = DBX + 2, DBY + 2, DBZ + 2
NC = cs.C1_CO
# one batch of the JAX comparisons: ragged against both boxes on every axis
SHAPE = (2, 9, 11, 20)
CO = 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Hundreds of small tensor operations: one torch thread, so that six
    test workers do not each run eight threads on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def blocks(n):
    """The plans with C1_BLOCKS = n (runs of several tiles and boxes)."""
    saved = cs.C1_BLOCKS
    cs.C1_BLOCKS = n
    cs.c1_plan.cache_clear()
    cs.c1_dw_plan.cache_clear()
    try:
        yield
    finally:
        cs.C1_BLOCKS = saved
        cs.c1_plan.cache_clear()
        cs.c1_dw_plan.cache_clear()


# --- a copy of csrc/conv3x3x3_c1.cu's arithmetic -----------------------------


def decode(tiles, t, box):
    """(b, z0, y0, x0) of tile or K box t: c1_tile, dw1_box."""
    nbx, nby, nbz = tiles
    t, tx = divmod(t, nbx)
    t, ty = divmod(t, nby)
    b, tz = divmod(t, nbz)
    return b, tz * box[2], ty * box[1], tx * box[0]


def load_halo(x, b, z0, y0, x0, shape):
    """c1_load_halo / dw1_load_halo: the (hz, hy, hx) box of x[b] from
    (z0 - 1, y0 - 1, x0 - 1), zero outside the volume."""
    out = torch.zeros(shape)
    src, dst = [], []
    for c, n, d in zip((z0 - 1, y0 - 1, x0 - 1), shape, x.shape[1:]):
        lo, hi = max(c, 0), min(c + n, d)
        src.append(slice(lo, hi))
        dst.append(slice(lo - c, hi - c))
    out[tuple(dst)] = x[(b, *src)]
    return out


def tap(k):
    return k // 9, (k // 3) % 3, k % 3


def fwd_offsets():
    """The forward's A column k -> halo offset of tap k from the voxel
    (off in the kernel) and whether k < 27 (kvalid)."""
    off = torch.tensor([(tap(k)[0] * HY + tap(k)[1]) * HX + tap(k)[2]
                        if k < 27 else 0 for k in range(32)])
    return off, torch.arange(32) < 27


def frag_channel(j, col):
    """Output channel (within a 32-channel chunk) of B column col of n8
    tile j: the kernel's weight-fragment permutation, under which the
    accumulators of a thread hold 8 consecutive channels."""
    return (col >> 1) * 8 + 2 * j + (col & 1)


def frag_weights(w, nchunks):
    """(32 taps, nchunks 32 B columns): the weight fragments, bf16 values
    of w (Co, 27), zero past tap 26 and past Co."""
    Co = w.shape[0]
    wk = torch.zeros(32, nchunks * NC)
    for nc in range(nchunks):
        for j in range(4):
            for col in range(8):
                n = nc * NC + frag_channel(j, col)
                if n < Co:
                    wk[:27, nc * NC + j * 8 + col] = w[n]
    return wk


def colsum(src):
    """colsum_f32 as conv_stack._colsum runs it: rows split over up to 256
    chunks, each summed in 8 row phases added in order; then the chunks."""
    def one_pass(rows, nsplit):
        chunk = -(-rows.shape[0] // nsplit)
        out = []
        for s in range(nsplit):
            part = rows[s * chunk:min(s * chunk + chunk, rows.shape[0])]
            tot = torch.zeros(rows.shape[1])
            for ph in range(8):
                tot = tot + part[ph::8].sum(0)
            out.append(tot)
        return torch.stack(out)
    nsplit = max(1, min(256, src.shape[0] // 64))
    mid = one_pass(src, nsplit)
    return mid[0] if nsplit == 1 else one_pass(mid, 1)[0]


def emulate_fwd(x, w, epilogue=None, stats=False):
    """conv3x3x3_c1_kernel on the CPU in f32: x (B, D, H, W), w (Co, 27).
    Returns (y (B, D, H, W, Co), the (2, Co) statistics after colsum)."""
    B, D, H, W = x.shape
    Co = w.shape[0]
    nchunks = -(-Co // NC)
    plan = cs.c1_plan(B, D, H, W)
    assert plan["args"] == (*plan["tiles"], plan["ntiles"], plan["per"],
                            plan["blocks"])
    wk = frag_weights(w, nchunks)
    off, kvalid = fwd_offsets()
    # rows of a tile: warp (y), z, then the 16 x of an m16 tile
    yy, zz, r = torch.meshgrid(torch.arange(BY), torch.arange(BZ),
                               torch.arange(BX), indexing="ij")
    base = ((zz * HY + yy) * HX + r).reshape(-1)
    chan = torch.tensor([nc * NC + frag_channel(j, col)
                         for nc in range(nchunks) for j in range(4)
                         for col in range(8)])
    y = torch.full((B, D, H, W, Co), float("nan"))
    rows = torch.zeros(plan["blocks"], 2 * Co)
    for blk in range(plan["blocks"]):
        red = torch.zeros(8, 2, nchunks * NC)
        for t in range(blk * plan["per"],
                       min((blk + 1) * plan["per"], plan["ntiles"])):
            b, z0, y0, x0 = decode(plan["tiles"], t, cs.C1_BOX)
            halo = load_halo(x, b, z0, y0, x0, (HZ, HY, HX)).reshape(-1)
            a = torch.where(kvalid, halo[base[:, None] + off[None, :]], 0.0)
            acc = torch.zeros(len(base), nchunks * NC)
            acc[:, chan] = a @ wk  # B column (j, col) -> its channel
            gz, gy, gx = (z0 + zz).reshape(-1), (y0 + yy).reshape(-1), \
                (x0 + r).reshape(-1)
            ok = (gz < D) & (gy < H) & (gx < W)
            acc = acc[:, :Co]
            if stats:
                v = torch.where(ok[:, None], acc, 0.0).reshape(8, -1, Co)
                red[:, 0, :Co] += v.sum(1)
                red[:, 1, :Co] += (v * v).sum(1)
            out = acc
            if epilogue is not None:
                s, sh = epilogue
                out = torch.relu(acc * s + sh)
            y[b, gz[ok], gy[ok], gx[ok]] = out[ok]
        tot = torch.zeros(2, nchunks * NC)
        for wp in range(8):
            tot = tot + red[wp]
        rows[blk] = tot[:, :Co].reshape(-1)
    st = colsum(rows).view(2, Co) if stats else None
    return y, st


def emulate_dw(x, dy):
    """conv3x3x3_c1_dw_kernel on the CPU in f32: x (B, D, H, W), dy (B, D,
    H, W, Co) -> dW (Co, 1, 3, 3, 3) after colsum."""
    B, D, H, W = x.shape
    Co = dy.shape[-1]
    plan = cs.c1_dw_plan(B, D, H, W, Co)
    n_co, nsplit = plan["grid"]
    assert plan["args"] == (*plan["tiles"], plan["nboxes"], plan["kboxes"],
                            nsplit)
    # A[r, k, vx]: box row r = z 8 + y, tap k, voxel x; copy kw % 2 of the
    # halo (copy 1 shifted by one element) at the aligned pair's element
    r = torch.arange(16)[:, None, None]
    k = torch.arange(32)[None, :, None]
    vx = torch.arange(16)[None, None, :]
    kd, kh, kw = k // 9, (k // 3) % 3, k % 3
    elem = (((r >> 3) + kd) * DHY + (r & 7) + kh) * DHX + vx + kw - kw % 2
    copy = (kw % 2).expand_as(elem)
    kvalid = (k < 27).expand_as(elem)
    part = torch.full((nsplit, 27, Co), float("nan"))
    for split in range(nsplit):
        kb0 = split * plan["kboxes"]
        kb1 = min(kb0 + plan["kboxes"], plan["nboxes"])
        assert kb1 > kb0
        for ct in range(n_co):
            co0 = ct * NC
            acc = torch.zeros(8, 32, NC)
            for kb in range(kb0, kb1):
                b, z0, y0, x0 = decode(plan["tiles"], kb, cs.C1_DW_BOX)
                h0 = load_halo(x, b, z0, y0, x0, (DHZ, DHY, DHX)).reshape(-1)
                h1 = torch.cat([h0[1:], torch.zeros(1)])
                hc = torch.stack([h0, h1])
                a = torch.where(kvalid, hc[copy, elem.clamp(max=len(h0) - 1)],
                                0.0)
                box = torch.zeros(DBZ, DBY, DBX, NC)
                src = dy[b, z0:z0 + DBZ, y0:y0 + DBY, x0:x0 + DBX,
                         co0:co0 + NC]
                box[:src.shape[0], :src.shape[1], :src.shape[2],
                    :src.shape[3]] = src
                box = box.reshape(16, 16, NC)  # row r = z 8 + y, x
                prod = a @ box  # (16 rows, 32 taps, 32 channels)
                for wp in range(8):
                    acc[wp] += prod[wp]
                    acc[wp] += prod[wp + 8]
            tot = torch.zeros(32, NC)
            for wp in range(8):
                tot = tot + acc[wp]
            cols = min(NC, Co - co0)
            part[split, :, co0:co0 + cols] = tot[:27, :cols]
    assert not torch.isnan(part).any()
    dw = colsum(part.reshape(nsplit, 27 * Co)) if nsplit > 1 else part[0]
    return dw.view(27, Co).t().reshape(Co, 1, 3, 3, 3)


# --- inputs and the references -----------------------------------------------


def _bf16(a):
    return torch.from_numpy(a).bfloat16().float()


@pytest.fixture(scope="module")
def case():
    """bf16-valued f32 inputs (the kernels round x and w to bf16) and the
    JAX references on them."""
    rng = np.random.default_rng(16)
    B, D, H, W = SHAPE
    x = _bf16(rng.normal(size=(B, D, H, W)).astype(np.float32))
    w = _bf16((rng.normal(size=(CO, 27)) * 0.3).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(B, D, H, W, CO)).astype(np.float32))
    s = torch.from_numpy(rng.uniform(0.5, 1.5, CO).astype(np.float32))
    t = torch.from_numpy((rng.normal(size=CO) * 0.3).astype(np.float32))
    # dram_tpu's entry stack: the CT channel zero-padded to 8, the weights'
    # input axis too (models/blocks.py:235-242); kernel layout DHWIO
    w_dhwio = w.numpy().T.reshape(3, 3, 3, 1, CO)
    xp = np.pad(x.numpy()[..., None], [(0, 0)] * 4 + [(0, 7)])
    wp = np.pad(w_dhwio, [(0, 0)] * 3 + [(0, 7), (0, 0)])
    z = jnp.zeros(8, jnp.float32)
    out, st = conv_cm(to_cm(jnp.asarray(xp)), _wk(jnp.asarray(wp),
                                                 jnp.float32),
                      z, z, H, W, D, prologue=False, stats=True,
                      interpret=True)
    dw = conv_dw_cm(to_cm(jnp.asarray(xp)), to_cm(jnp.asarray(dy.numpy())),
                    z, z, H, W, D, prologue=False, interpret=True)
    yp, vjp = jax.vjp(lambda a, b: conv3d_pallas(a, b, interpret=True),
                      jnp.asarray(x.numpy()[..., None]),
                      jnp.asarray(w_dhwio))
    _, dw3 = vjp(jnp.asarray(dy.numpy()))
    to_port = lambda a: torch.from_numpy(  # noqa: E731
        np.asarray(a)[:, :, :, :1].transpose(4, 3, 0, 1, 2).copy())
    return {"x": x, "w": w, "w5": w.view(CO, 1, 3, 3, 3), "dy": dy,
            "s": s, "t": t,
            "conv_cm": torch.tensor(np.asarray(from_cm(out, H, W))),
            "conv_cm_stats": torch.tensor(np.asarray(st)),
            "conv_dw_cm": to_port(dw),
            "conv3d_pallas": torch.tensor(np.asarray(yp)),
            "conv3d_pallas_dw": to_port(dw3)}


def close(got, want, rtol=1e-5):
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=rtol * want.abs().max().item())


# --- (a) the plans -----------------------------------------------------------

# ragged shapes, and the golden's 48^3, the flagship's 80^3 chunks at the
# scan's and the step's batches, the overlap tile's 160 x 80 x 80 and
# variant B's 64^3 / 96^3
PLAN_SHAPES = [(1, 5, 7, 9), (2, 9, 11, 20), (3, 17, 8, 33), (2, 48, 48, 48),
               (5, 80, 80, 80), (10, 80, 80, 80), (2, 160, 80, 80),
               (4, 64, 64, 64), (2, 96, 96, 96)]


def test_c1_plan_covers_each_output_voxel_once():
    for B, D, H, W in PLAN_SHAPES:
        p = cs.c1_plan(B, D, H, W)
        count = np.zeros((B, D + BZ, H + BY, W + BX), np.int32)
        for blk in range(p["blocks"]):
            t0, t1 = blk * p["per"], min((blk + 1) * p["per"], p["ntiles"])
            assert t1 > t0
            for t in range(t0, t1):
                b, z0, y0, x0 = decode(p["tiles"], t, cs.C1_BOX)
                count[b, z0:z0 + BZ, y0:y0 + BY, x0:x0 + BX] += 1
        assert (count[:, :D, :H, :W] == 1).all(), (B, D, H, W)
        assert p["ntiles"] == B * int(np.prod(p["tiles"]))
        assert p["stat_rows"] == p["blocks"] <= cs.C1_BLOCKS


def test_c1_dw_plan_covers_each_voxel_once():
    for (B, D, H, W), Co in zip(PLAN_SHAPES, (32, 32, 6, 32, 32, 32, 32, 40,
                                              32)):
        p = cs.c1_dw_plan(B, D, H, W, Co)
        count = np.zeros((B, D + DBZ, H + DBY, W + DBX), np.int32)
        for split in range(p["nsplit"]):
            kb0 = split * p["kboxes"]
            kb1 = min(kb0 + p["kboxes"], p["nboxes"])
            assert kb1 > kb0
            for kb in range(kb0, kb1):
                b, z0, y0, x0 = decode(p["tiles"], kb, cs.C1_DW_BOX)
                count[b, z0:z0 + DBZ, y0:y0 + DBY, x0:x0 + DBX] += 1
        assert (count[:, :D, :H, :W] == 1).all(), (B, D, H, W)
        assert p["grid"] == (-(-Co // NC), p["nsplit"])
        assert np.prod(p["grid"]) <= max(cs.C1_BLOCKS, p["grid"][0])


# --- (b) the emulations against the plain versions and JAX -------------------


@pytest.mark.parametrize("nblocks", [None, 3], ids=["plan", "runs"])
def test_forward_emulation_eval_and_stats(case, nblocks):
    """Eval (relu(acc s + t), once) and raw + statistics against the plain
    versions and conv_cm on the 8-padded input; with 3 blocks each block
    runs several tiles into its statistics row."""
    x, w, w5 = case["x"], case["w"], case["w5"]
    ep = (case["s"], case["t"])
    with blocks(nblocks) if nblocks else contextlib.nullcontext():
        y, st = emulate_fwd(x, w, stats=True)
        ye, _ = emulate_fwd(x, w, epilogue=ep)
    xt = x[..., None]
    yp, stp = cs.conv3x3x3_c1_plain(xt, w5, stats=True)
    close(y, yp)
    close(y, case["conv_cm"])
    close(st, stp)
    close(st, case["conv_cm_stats"])
    close(ye, cs.conv3x3x3_c1_plain(xt, w5, epilogue=ep)[0])
    close(ye, torch.relu(case["conv_cm"] * ep[0] + ep[1]))


@pytest.mark.parametrize("nblocks", [None, 4], ids=["plan", "runs"])
def test_dw_emulation(case, nblocks):
    """Split-K partial rows through colsum_f32 against the plain version,
    conv_dw_cm's 8-padded dW (its first input channel) and the VJP of
    conv3d_pallas at Ci = 1."""
    with blocks(nblocks) if nblocks else contextlib.nullcontext():
        got = emulate_dw(case["x"], case["dy"])
    close(got, cs.conv3x3x3_c1_dw_plain(case["x"][..., None], case["dy"]))
    close(got, case["conv_dw_cm"])
    close(got, case["conv3d_pallas_dw"])


def test_raw_emulation_vs_conv3d_pallas(case):
    """The unfused stack's raw entry conv: conv3d_pallas at Ci = 1."""
    y, _ = emulate_fwd(case["x"], case["w"])
    close(y, conv3d.conv3d_plain(case["x"][..., None], case["w5"]))
    close(y, case["conv3d_pallas"][..., :CO])


def test_emulation_chunks_and_narrow_outputs():
    """Co = 40 (a second, partial 32-channel chunk) and Co = 6 (the pair
    stores), against the plain versions."""
    rng = np.random.default_rng(17)
    for Co, shape in ((40, (1, 9, 8, 17)), (6, (2, 5, 9, 7))):
        x = _bf16(rng.normal(size=shape).astype(np.float32))
        w = _bf16(rng.normal(size=(Co, 27)).astype(np.float32))
        dy = torch.from_numpy(rng.normal(size=(*shape, Co)).astype(np.float32))
        y, st = emulate_fwd(x, w, stats=True)
        yp, stp = cs.conv3x3x3_c1_plain(x[..., None], w.view(Co, 1, 3, 3, 3),
                                        stats=True)
        close(y, yp)
        close(st, stp)
        close(emulate_dw(x, dy), cs.conv3x3x3_c1_dw_plain(x[..., None], dy))


# --- (c) routing at the flagship's widths ------------------------------------


@contextlib.contextmanager
def launches_on_meta(monkeypatch):
    """Tensors on the meta device that pass for CUDA ones: the wrappers
    take their kernels' paths, and each launcher call is recorded
    (launcher name, channel arguments) instead of run. pad8 fails if it
    would pad anything."""
    calls = collections.Counter()
    chans = []

    def launch(name, *args):
        calls[name] += 1
        if name == "conv3x3x3_wgmma_bf16":
            chans.append((args[1], args[3]))
        elif name == "conv3x3x3_dw_wgmma_bf16":
            chans.append((args[1], args[3], args[7]))

    orig = cs.pad8

    def pad8(t, parts=None, dim=-1):
        parts = tuple(parts) if parts is not None else (t.shape[dim],)
        assert all(c % 8 == 0 for c in parts), f"pad8 would pad {parts}"
        return orig(t, parts, dim)
    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(cs, "pad8", pad8)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    for k in ("conv3x3x3", "conv3x3x3_train", "conv3x3x3_dx",
              "conv3x3x3_dw", "conv3x3x3_c1", "conv3x3x3_c1_dw"):
        monkeypatch.setattr(getattr(cs, k), "launches", 0)
    for k in ("conv3d", "conv3d_dx", "conv3d_dw"):
        monkeypatch.setattr(getattr(conv3d, k), "launches", 0)
    yield calls, chans


def counts():
    return {k: getattr(m, k).launches for m, ks in (
        (cs, ("conv3x3x3", "conv3x3x3_train", "conv3x3x3_dx", "conv3x3x3_dw",
              "conv3x3x3_c1", "conv3x3x3_c1_dw")),
        (conv3d, ("conv3d", "conv3d_dx", "conv3d_dw"))) for k in ks
        if getattr(m, k).launches}


def _flagship(fused, train):
    with torch.device("meta"):
        m = DC3D(stacking=3, dtype=torch.bfloat16, fused_stack=fused)
        x = torch.empty(10, 80, 80, 80, 1, dtype=torch.bfloat16)
    return m.train(train), x


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_routing_training_step(monkeypatch, fused):
    """A flagship training forward and backward: ds_0.conv_0's forward and
    dW are the only c1 launches (raw + statistics fused, raw unfused), the
    13 other convs run the wgmma kernels on parts that are multiples of 8
    (pad8 pads nothing), and the CT input gets no dx."""
    with launches_on_meta(monkeypatch) as (calls, chans):
        m, x = _flagship(fused, True)
        out = m(x)
        fwd = dict(calls)
        sum(o.float().sum() for o in out).backward()
    c = counts()
    if fused:
        assert c == {"conv3x3x3_train": 13, "conv3x3x3_dx": 13,
                     "conv3x3x3_dw": 13, "conv3x3x3_c1": 1,
                     "conv3x3x3_c1_dw": 1}
    else:
        assert c == {"conv3d": 13, "conv3d_dx": 13, "conv3d_dw": 13,
                     "conv3x3x3_c1": 1, "conv3x3x3_c1_dw": 1}
    assert fwd["conv3x3x3_c1_bf16"] == 1 and fwd["conv3x3x3_wgmma_bf16"] == 13
    assert calls["conv3x3x3_c1_dw_bf16"] == 1
    assert calls["conv3x3x3_dw_wgmma_bf16"] == 13
    assert all(ch % 8 == 0 for call in chans for ch in call[:2])


def test_routing_eval_and_refusals(monkeypatch):
    """The eval forward takes the c1 kernel once (its epilogue) and the
    wgmma kernel 13 times; the wgmma launchers refuse a Ci = 1 launch, and
    the c1 forward refuses the epilogue with the statistics."""
    with launches_on_meta(monkeypatch) as (calls, _):
        m, x = _flagship(True, False)
        with torch.no_grad():
            m(x)
        assert counts() == {"conv3x3x3": 13, "conv3x3x3_c1": 1}
        assert calls["conv3x3x3_c1_bf16"] == 1
        w = torch.zeros(32, 1, 3, 3, 3, device="meta")
        dy = torch.empty(1, 8, 8, 8, 32, dtype=torch.bfloat16, device="meta")
        xs = x[:1, :8, :8, :8].contiguous()
        with pytest.raises(ValueError, match="conv3x3x3_c1"):
            cs.launch_train(xs, w, None, None, True, "conv3x3x3_train")
        with pytest.raises(ValueError, match="conv3x3x3_c1"):
            cs.launch_dw(xs, dy, None, None, "conv3x3x3_dw")
        with pytest.raises(ValueError, match="separate modes"):
            cs.conv3x3x3_c1(xs, w, epilogue=(w[:, 0, 0, 0, 0],) * 2,
                            stats=True)
    # the predicate: one part of one channel and no prologue
    one = torch.empty(1, 2, 2, 2, 1, device="meta")
    assert cs.c1_takes(one, None, None)
    assert not cs.c1_takes(one, one, None)
    assert not cs.c1_takes(one, None, (one, one))
    assert not cs.c1_takes(torch.empty(1, 2, 2, 2, 8, device="meta"), None,
                           None)

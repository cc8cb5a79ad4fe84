"""The port's multi-device library (dram_tpu_torch/core/mesh.py and what
carries a process group) against dram_tpu's on the fake 8-device CPU
mesh of tests/conftest.py: the batch layout; on 3 gloo ranks gsum and
the four losses with sample weights; on 2 gloo ranks the fused conv
stack's statistics and gradient, the train-mode BatchNorms, halo
exchange, the sharded stencil apply, the sharded PCM and overlap tiles.
The ranks are processes of tests/_torch_port_dist_worker.py (one process
group per case, its sub-cases looped inside it); the JAX side runs here
under shard_map."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import dram_tpu.models.pcm as jpcm
from dram_tpu.core import mesh as jmesh
from dram_tpu.core.ops import gsum as jgsum
from dram_tpu.core.pallas.fused_stack import fused_cbr2
from dram_tpu.losses.bootstrap_bce import BootBinCrossEntropy as JBoot
from dram_tpu.losses.equivariance import smooth_l1_masked as jsmooth
from dram_tpu.losses.interval_reg import (compute_enc_loss as jenc,
                                          compute_reg_loss_with_probs as jreg)
from dram_tpu.losses.refine import IntRegRefineLoss as JRefine
from dram_tpu.models import DC3D as JaxDC3D
from dram_tpu.models.blocks import make_norm

import _torch_port_dist_worker as worker
from dram_tpu_torch import weights
from dram_tpu_torch.core import mesh
from dram_tpu_torch.kernels.window_attention import stencil_offsets
from dram_tpu_torch.models import DC3D
from dram_tpu_torch.models.initializers import HeNorm
from dram_tpu_torch.models.pcm import PCM
from dram_tpu_torch.train.runner import rank_rows


def _mesh(n, name="data"):
    return Mesh(np.array(jax.devices()[:n]), (name,))


def _close(got, want, rel, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def test_batch_layout_matches_dram_tpu():
    """pad_batch and the rows of each rank equal dram_tpu's pad_batch and
    the rows its batch sharding gives each device, for world 2, 3 and 8
    and global batches 3 to 10; per-rank loading's rows; DCN sizes divide
    the world or raise as best_mesh does."""
    rng = np.random.default_rng(0)
    for world in (2, 3, 8):
        jm = jmesh.best_mesh(devices=jax.devices()[:world])
        for b in range(3, 11):
            a = rng.normal(size=(b, 2)).astype(np.float32)
            c = np.arange(b)
            (pa, pc), w = mesh.pad_batch((a, c), world)
            (ja, jc), jw = jmesh.pad_batch((a, c), world)
            np.testing.assert_array_equal(pa, ja)
            np.testing.assert_array_equal(pc, jc)
            np.testing.assert_array_equal(w, jw)
            _, padded = jmesh.local_batch_rows(jm, b)
            sh = NamedSharding(jm, jmesh.batch_spec(jm))
            idx = sh.devices_indices_map((padded,))
            for r, dev in enumerate(jm.devices.flat):
                sl = idx[dev][0]
                assert mesh.local_batch_rows(world, r, b) == \
                    ((sl.start or 0, sl.stop or padded), padded)
    # per-rank loading (train/runner.py:rank_rows): the real rows of each
    # rank's share, and a rank owning only padding loads the last row
    assert rank_rows(2, 1, 9) == (((5, 10), 10, 4), (5, 9))
    assert rank_rows(8, 2, 3) == (((2, 3), 8, 1), (2, 3))
    assert rank_rows(8, 5, 3) == (((5, 6), 8, 0), (2, 3))
    for world, dcn in ((8, 2), (8, 4), (6, 3)):
        mesh.check_dcn_size(dcn, world)
        jmesh.best_mesh(devices=jax.devices()[:world], dcn_axis="dcn",
                        dcn_size=dcn)
    for world, dcn in ((8, 3), (6, 4)):
        with pytest.raises(ValueError, match="DCN groups"):
            mesh.check_dcn_size(dcn, world)
        with pytest.raises(ValueError, match="DCN groups"):
            jmesh.best_mesh(devices=jax.devices()[:world], dcn_axis="dcn",
                            dcn_size=dcn)


def test_backend_choice_and_single_process(monkeypatch):
    """NCCL only when every rank of the host has its own GPU; without
    torchrun's environment there is no group and nothing changes."""
    assert mesh.backend_for("cuda", 2, 2) == "nccl"
    assert mesh.backend_for("cuda", 2, 1) == "gloo"
    assert mesh.backend_for("cpu", 2, 0) == "gloo"
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh.maybe_init_distributed("cpu") is False
    assert mesh.data_group() is None
    x = torch.arange(6.0).reshape(6, 1)
    ext = mesh.halo_exchange(x, 1, 0, None)
    assert ext.shape == (8, 1) and ext[0] == 0 and ext[-1] == 0
    assert torch.equal(mesh.sharded_stencil_apply(lambda v: v, x, 1, None),
                       x)


def _loss_inputs():
    rng = np.random.default_rng(5)
    shape = (6, 4, 4, 4, 1)  # global batch 5, padded to 6 on 3 ranks
    return {"p": rng.uniform(0.05, 0.95, shape).astype(np.float32),
            "other": rng.uniform(0.05, 0.95, shape).astype(np.float32),
            "target": (rng.random(shape) > 0.6).astype(np.float32),
            "lobes": (rng.random(shape) > 0.3).astype(np.float32),
            "lesions": (rng.random(shape) > 0.5).astype(np.float32),
            "ctss": np.array([1, 2, 3, 0, 4, 1], np.int32),
            "freq": np.array([0.3, 0.25, 0.23, 0.2, 0.18, 0.15], np.float32),
            "w": np.array([1, 1, 1, 1, 1, 0], np.float32)}


def test_gsum_and_losses_match_dram_tpu_on_3_ranks(tmp_path):
    """Each loss's value and its gradient in every rank's probabilities
    (the world size times its rows' share, as psum transposes to psum)
    against dram_tpu's under shard_map with `axis_name` on 3 fake
    devices, a padded row of weight 0 included (1e-5)."""
    inp = _loss_inputs()
    got = worker.spawn("losses", 3, str(tmp_path), inp)
    m = _mesh(3)
    a = {k: jnp.asarray(v) for k, v in inp.items()}
    fns = {
        "gsum": lambda p, d: jgsum(p, "data"),
        "enc": lambda p, d: jenc(p, d["w"], "data"),
        "enc_unweighted": lambda p, d: jenc(p, None, "data"),
        "reg": lambda p, d: jreg(p, d["lobes"], d["lesions"], d["ctss"],
                                 1e-2, a["freq"], d["w"], "data"),
        "boot": lambda p, d: JBoot(0.1)(p, d["target"], d["lobes"],
                                        sample_weight=d["w"],
                                        axis_name="data"),
        "seg": lambda p, d: JRefine(1e-2, 0.1).compute_seg_loss(
            jnp.log(p / (1 - p)), p * 2.0 - 0.5, d["lobes"], d["lesions"],
            d["ctss"], d["w"], "data"),
        "smooth_l1": lambda p, d: jsmooth(p, d["other"], d["lobes"] > 0,
                                          sample_weight=d["w"],
                                          axis_name="data"),
    }
    keys = ("other", "target", "lobes", "lesions", "ctss", "w")
    for name, fn in fns.items():
        def local(p, *rest):
            d = dict(zip(keys, rest))
            v, g = jax.value_and_grad(lambda q: fn(q, d))(p)
            return v, g
        f = jax.jit(shard_map(local, mesh=m, in_specs=(P("data"),) * 7,
                              out_specs=(P(), P("data")), check_vma=False))
        jv, jg = f(a["p"], *(a[k] for k in keys))
        for r, res in enumerate(got):
            v, g = res[name]
            np.testing.assert_allclose(v, float(jv), rtol=1e-5,
                                       err_msg=f"{name} rank {r}")
            _close(g, np.asarray(jg)[2 * r:2 * r + 2], 1e-5,
                   f"{name} gradient rank {r}")
        if name != "gsum" and name != "enc_unweighted":
            # the weight-0 row leaves no gradient
            assert not got[2][name][1][1].any(), name


def _bn(rng, c):
    return (rng.uniform(0.5, 1.5, c).astype(np.float32),
            (rng.normal(size=c) * 0.1).astype(np.float32),
            (rng.normal(size=c) * 0.05).astype(np.float32),
            rng.uniform(0.5, 1.5, c).astype(np.float32))


def _pcm_cases(rng):
    """k = 3 (connectivity 2, two residual iterations, D = 8) and an
    asymmetric k = 5 sub-stencil (offsets with dz = +2 whose mirror image
    it lacks; one iteration, D = 7 padded to 8), float64, parameters drawn
    from the flax tree's shapes."""
    k5 = [o for o in stencil_offsets(5, 1, True) if o[1] == 0 or o[2] == 0]
    sub = tuple(o for o in k5 if abs(o[0]) <= 1 or o[0] == 2)[::3]
    assert any(o[0] == 2 for o in sub) and not any(o[0] == -2 for o in sub)
    cases = []
    for kw, d, offsets in (
            (dict(f_dim=3, g_dim=4, non_local_iter=2, k_size=3,
                  connectivity=2, self_loop=False, residual=True), 8, None),
            (dict(f_dim=4, g_dim=3, non_local_iter=1, k_size=5,
                  connectivity=1, self_loop=True), 7, sub)):
        kw = dict(g_ch=1, merge_type="scaled_dot_product_relu", p_enc_dim=0,
                  **kw)
        cam = rng.normal(size=(2, d, 6, 5, 1))
        f = rng.normal(size=(2, d, 6, 5, 5))
        jm = jpcm.PCM(pool_size=(d, 6, 5), dtype=jnp.float64, **kw)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.asarray(cam), jnp.asarray(f))["params"]
        params = jax.tree_util.tree_map(
            lambda s: rng.uniform(-1, 1, s.shape), shapes)
        cases.append({"kw": kw, "cam": cam, "f": f, "params": params,
                      "offsets": offsets, "jm": jm})
    return cases


OVERLAP_CFG = dict(n_layers=2, base_ch_list=(4, 8, 16, 16, 8),
                   end_ch_list=(8, 16, 32, 16, 8), stacking=2,
                   local_upsample=True)


def test_library_matches_dram_tpu_on_2_ranks(tmp_path, monkeypatch):
    """On 2 gloo ranks against dram_tpu on 2 fake devices:
    ConvStackFunction's output, running statistics, input gradient and
    (summed over the ranks) parameter gradients against fused_cbr2(train,
    axis_name) in interpret mode (5e-3, tests/test_torch_port_backward.py's
    bar); the BatchNorms against flax's: 'bn' global, 'bnt' and the tap
    heads' local (1e-5); halo_exchange and its gradient, and
    sharded_stencil_apply (exact up to f32 sums); pcm_sharded at k = 3 and
    on an asymmetric k = 5 sub-stencil against dram_tpu's pcm_sharded and
    the unsharded PCM (float64, 1e-10); overlap_tile_infer of a
    local-upsample DC3D against dram_tpu's and the unsharded forward
    (1e-4 of the largest)."""
    rng = np.random.default_rng(16)
    B, SD, H, W, ci, c0, c1 = 4, 4, 8, 8, 8, 16, 8
    conv = {"x": rng.normal(size=(B, SD, H, W, ci)).astype(np.float32),
            "w0": (rng.normal(size=(3, 3, 3, ci, c0)) * 0.2).astype(
                np.float32),
            "w1": (rng.normal(size=(3, 3, 3, c0, c1)) * 0.2).astype(
                np.float32),
            "bn0": _bn(rng, c0), "bn1": _bn(rng, c1),
            "cot": rng.normal(size=(B, SD, H, W, c1)).astype(np.float32)}
    bn = {"x": (rng.normal(size=(4, 3, 4, 4, 3)) * 2 + 1).astype(np.float32),
          "scale": rng.uniform(0.5, 1.5, 3).astype(np.float32),
          "bias": rng.normal(size=3).astype(np.float32),
          "cot": rng.normal(size=(4, 3, 4, 4, 3)).astype(np.float32)}
    halo = {"vol": rng.normal(size=(16, 3)).astype(np.float32), "halo": 2,
            "cot": rng.normal(size=(24, 3)).astype(np.float32)}
    pcm_cases = _pcm_cases(rng)
    model = DC3D(**OVERLAP_CFG)
    HeNorm()(model, torch.Generator().manual_seed(3))
    with torch.no_grad():
        for name, b in model.named_buffers():
            b.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, b.shape)
                                     .astype(np.float32)))
    params, bs = weights.to_jax(model.state_dict())
    ov = {"cfg": OVERLAP_CFG, "params": params, "bs": bs, "n_tiles": 2,
          "halo": 24,
          "x": rng.normal(size=(1, 64, 16, 16, 1)).astype(np.float32),
          "lobe": (rng.random((1, 64, 16, 16, 1)) > 0.3).astype(np.float32)}
    inp = {"conv": conv, "bn": bn, "halo": halo, "overlap": ov,
           "pcm": [{k: c[k] for k in ("kw", "cam", "f", "params",
                                      "offsets")} for c in pcm_cases]}
    got = worker.spawn("library", 2, str(tmp_path), inp)
    m2 = _mesh(2)

    # the fused stack
    (g0, b0, mu0, v0), (g1, b1, mu1, v1) = conv["bn0"], conv["bn1"]
    cst = [jnp.asarray(v) for v in (mu0, v0, mu1, v1)]
    jargs = [jnp.asarray(v) for v in (conv["w0"], g0, b0, conv["w1"], g1,
                                      b1)]

    def cb_local(x, cot):
        def lossf(x, w0, g0, b0, w1, g1, b1):
            y, new = fused_cbr2(x, w0, g0, b0, cst[0], cst[1], w1, g1, b1,
                                cst[2], cst[3], train=True, interpret=True,
                                axis_name="data")
            return jnp.sum(y * cot), (y, new)
        (_, (y, new)), g = jax.value_and_grad(
            lossf, argnums=tuple(range(7)), has_aux=True)(x, *jargs)
        return y, g[0], [jax.lax.psum(t, "data") for t in g[1:]], new
    f = jax.jit(shard_map(cb_local, mesh=m2, in_specs=(P("data"), P("data")),
                          out_specs=(P("data"), P("data"), P(), P()),
                          check_vma=False))
    jy, jdx, jg, jnew = f(jnp.asarray(conv["x"]), jnp.asarray(conv["cot"]))
    for r, res in enumerate(got):
        c = res["conv"]
        sl = slice(2 * r, 2 * r + 2)
        _close(c["y"], np.asarray(jy)[sl], 5e-3, f"stack y rank {r}")
        _close(c["dx"], np.asarray(jdx)[sl], 5e-3, f"stack dx rank {r}")
        for i, (a, b) in enumerate(zip(c["grads"], jg)):
            b = np.asarray(b)
            if b.ndim == 5:
                b = b.transpose(4, 3, 0, 1, 2)
            _close(a, b, 5e-3, f"stack grad {i} rank {r}")
        for a, b in zip(c["stats"], jnew):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4,
                                       atol=1e-4)

    # train-mode BatchNorm
    class Norm(fnn.Module):
        kind: str

        @fnn.compact
        def __call__(self, x):
            if self.kind == "head":  # dram_tpu's _ReshapeHead norm
                return fnn.BatchNorm(use_running_average=False, momentum=0.9,
                                     epsilon=1e-5)(x)
            return make_norm(self.kind, jnp.float32, "data")(False)(x)

    for kind in ("bn", "sbn", "bnt", "head"):
        nm = Norm(kind)
        v = {"params": {"BatchNorm_0": {"scale": jnp.asarray(bn["scale"]),
                                        "bias": jnp.asarray(bn["bias"])}},
             "batch_stats": {"BatchNorm_0": {"mean": jnp.zeros(3),
                                             "var": jnp.ones(3)}}}

        def bn_local(x, cot):
            def lossf(x):
                y, st = nm.apply(v, x, mutable=["batch_stats"])
                return jnp.sum(y * cot), (y, st["batch_stats"]["BatchNorm_0"])
            (_, (y, st)), dx = jax.value_and_grad(lossf, has_aux=True)(x)
            return y, dx, st["mean"][None], st["var"][None]
        f = jax.jit(shard_map(bn_local, mesh=m2,
                              in_specs=(P("data"), P("data")),
                              out_specs=(P("data"),) * 4, check_vma=False))
        jy, jdx, jmean, jvar = f(jnp.asarray(bn["x"]), jnp.asarray(bn["cot"]))
        for r, res in enumerate(got):
            c = res["bn"]["bn" if kind == "sbn" else kind]
            sl = slice(2 * r, 2 * r + 2)
            _close(c["y"], np.asarray(jy)[sl], 1e-5, f"{kind} y rank {r}")
            _close(c["dx"], np.asarray(jdx)[sl], 1e-5, f"{kind} dx rank {r}")
            _close(c["mean"], np.asarray(jmean)[r], 1e-5, f"{kind} mean")
            _close(c["var"], np.asarray(jvar)[r], 1e-5, f"{kind} var")
    # 'bn' is global: both ranks agree; 'bnt' and the heads are local
    g = [res["bn"] for res in got]
    np.testing.assert_array_equal(g[0]["bn"]["mean"], g[1]["bn"]["mean"])
    assert not np.allclose(g[0]["bnt"]["mean"], g[1]["bnt"]["mean"])
    assert not np.allclose(g[0]["head"]["var"], g[1]["head"]["var"])

    # halo exchange and its gradient; the sharded stencil apply
    ms = _mesh(2, "space")
    hx = shard_map(lambda blk: jmesh.halo_exchange(blk, "space", 2, 0),
                   mesh=ms, in_specs=(P("space"),), out_specs=P("space"))
    vol, cot = jnp.asarray(halo["vol"]), jnp.asarray(halo["cot"])
    jext = np.asarray(hx(vol))
    jgrad = np.asarray(jax.grad(lambda v: jnp.sum(hx(v) * cot))(vol))
    np.testing.assert_array_equal(
        np.concatenate([res["halo"]["ext"] for res in got]), jext)
    _close(np.concatenate([res["halo"]["grad"] for res in got]), jgrad,
           1e-6, "halo gradient")

    def mean3(b):
        z = b[:1] * 0
        return (jnp.concatenate([z, b[:-1]]) + b
                + jnp.concatenate([b[1:], z])) / 3.0
    jst = np.asarray(jmesh.sharded_stencil_apply(mean3, vol, ms, halo=1))
    for res in got:
        _close(res["halo"]["stencil"], jst, 1e-6, "stencil apply")

    # the sharded PCM (float64)
    with jax.enable_x64(True):
        for c, outs in zip(pcm_cases, zip(*[res["pcm"] for res in got])):
            if c["offsets"] is not None:
                monkeypatch.setattr(jpcm, "stencil_offsets",
                                    lambda *a, o=c["offsets"]: o)
            v = {"params": c["params"]}
            cam, f = jnp.asarray(c["cam"]), jnp.asarray(c["f"])
            want = np.asarray(jax.jit(c["jm"].apply)(v, cam, f))
            jsh = np.asarray(jax.jit(
                lambda cm, x: jpcm.pcm_sharded(c["jm"], v, cm, x, ms))(cam, f))
            _close(jsh, want, 1e-10, "dram_tpu's sharded vs unsharded PCM")
            for r, out in enumerate(outs):
                _close(out, jsh, 1e-10, f"pcm_sharded k={c['kw']['k_size']} "
                       f"rank {r}")
            # the port's unsharded PCM on the same stencil
            pm = PCM(in_ch=5, **c["kw"]).double()
            if c["offsets"] is not None:
                pm.offsets = c["offsets"]
            weights.load_into(pm, c["params"], {})
            with torch.no_grad():
                one = pm(torch.from_numpy(c["cam"]), torch.from_numpy(c["f"]))
            _close(one.numpy(), want, 1e-10, "port's unsharded PCM")
            monkeypatch.undo()

    # overlap tiles
    jm = JaxDC3D(train=False, **OVERLAP_CFG)

    def apply_fn(xb, lb):
        return jm.apply({"params": params, "batch_stats": bs}, xb, lb)
    x, lobe = jnp.asarray(ov["x"]), jnp.asarray(ov["lobe"])
    jd, jr = jmesh.overlap_tile_infer(jax.jit(apply_fn), x, lobe, n_tiles=2,
                                      halo=24, mesh=m2)
    with torch.no_grad():
        whole, _ = model.eval()(torch.from_numpy(ov["x"]))
    for r, res in enumerate(got):
        _close(res["overlap"]["dense"], np.asarray(jd), 1e-4,
               f"overlap dense rank {r}")
        _close(res["overlap"]["refined"], np.asarray(jr), 1e-4,
               f"overlap refined rank {r}")
        _close(res["overlap"]["dense"], whole.numpy(), 1e-5,
               "overlap vs the unsharded forward")

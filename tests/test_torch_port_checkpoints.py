"""Pieces of the port's training loop against dram_tpu on the CPU: the
validation forward (FastScanPipeline.process_chunks_val) against
dram_tpu's on a narrow flagship with seeded numpy weights (no JAX init to
compile), pooling_dense_features, the scheduler state, a dram_tpu-format optimizer state (two
optax updates, saved by dram_tpu's checkpoint writer) reloaded into the
port's Adam with the next update within 1e-6 of optax's, and the import
of reference torch state dicts (train/torch_import.py) against
dram_tpu's."""

import jax
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import dram_tpu.train.checkpoint as jcheckpoint
from dram_tpu.core import ops as jops
from dram_tpu.infer import fast as jfast
from dram_tpu.models import DC3DATGeneric as JaxDC3DATGeneric
from dram_tpu.train import torch_import as jtorch_import
from dram_tpu.train import trainer as jtrainer

from dram_tpu_torch import weights
from dram_tpu_torch.core import ops
from dram_tpu_torch.infer import fast
from dram_tpu_torch.losses.interval_reg import ratio_to_label
from dram_tpu_torch.models import DC3D, DC3DATGeneric
from dram_tpu_torch.train import checkpoint, torch_import, trainer

from test_torch_port_hostprep import SPACING, _scan
from test_torch_port_infer import NARROW, SPAN

CHUNK = (16, 16, 16)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_dc3d():
    torch.manual_seed(0)
    return DC3D(n_layers=2, base_ch_list=(4, 8, 16, 16, 8),
                end_ch_list=(8, 16, 32, 16, 8), stacking=2)


def test_process_chunks_val_matches_jax():
    """The validation forward of both packages on the C++ chunk prep of
    one scan (bit-equal preps) with the same weights: the ratio within
    1e-4 relative and the same ordinal label."""
    pm = DC3DATGeneric(**NARROW).eval()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, t in pm.state_dict().items():
            if name.endswith("running_var") or (
                    t.ndim == 1 and name.endswith("weight")):
                a = rng.uniform(0.5, 1.5, t.shape)
            elif t.ndim == 1:
                a = rng.normal(size=t.shape) * 0.1
            else:
                a = rng.normal(size=t.shape) * np.sqrt(2.0 / t[0].numel())
            t.copy_(torch.from_numpy(a))
    params, batch_stats = weights.to_jax(pm.state_dict())
    jpipe = jfast.FastScanPipeline(JaxDC3DATGeneric(train=False, **NARROW),
                                   params, batch_stats, chunk_size=CHUNK,
                                   windowing_span=SPAN)
    ppipe = fast.FastScanPipeline(pm, device="cpu", chunk_size=CHUNK,
                                  windowing_span=SPAN)
    scan, lobe, _ = _scan(11, (20, 40, 35), lesion_severity=[3, 4, 2, 5, 3])
    lobe[lobe == 4] = 0  # an absent lobe: `present` gates it
    prep = dict(spacing=SPACING, windowing_span=SPAN, chunk_size=CHUNK)
    want = jpipe.process_chunks_val(jfast.prep_scan_chunks(scan, lobe,
                                                           **prep))
    pprep = fast.prep_scan_chunks(scan, lobe, **prep)
    assert list(pprep["present"]) == [1, 1, 1, 0, 1]
    got = ppipe.process_chunks_val(pprep)
    assert isinstance(got, float) and 0.0 < want < 1.0
    assert abs(got - want) <= 1e-4 * abs(want)
    assert ratio_to_label([got]) == ratio_to_label([want])


def test_scheduler_state_matches_jax():
    a, b = trainer.ExponentialLR(1e-3, 0.9), jtrainer.ExponentialLR(1e-3, 0.9)
    for s in (a, b):
        s.step()
        s.step()
    assert a.state_dict() == b.state_dict()
    c = trainer.ExponentialLR(5.0, 0.5)
    c.load_state_dict(b.state_dict())
    assert c.lr == b.lr


def test_optax_state_reloads_into_port_adam(tmp_path):
    """A dram_tpu-format optimizer state from two optax updates, saved by
    dram_tpu's checkpoint writer, loaded into the port's Adam: the third
    update equals optax's within 1e-6."""
    model = _tiny_dc3d()
    params = weights.to_jax(dict(model.named_parameters()))[0]
    rng = np.random.default_rng(4)
    grads = [jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        for _ in range(3)]
    tx, _ = jtrainer.adam(lr=1e-3)
    update = jax.jit(tx.update)
    p, st = params, tx.init(params)
    for g in grads[:2]:
        upd, st = update(g, st, p)
        p = optax.apply_updates(p, upd)
    path = str(tmp_path / "optax.ckpt")
    jcheckpoint.save_checkpoint(path, {
        "model": {"params": jax.tree_util.tree_map(np.asarray, p)},
        "optimizer": serialization.to_state_dict(st)})
    upd, _ = update(grads[2], st, p)
    want = optax.apply_updates(p, upd)

    saved = checkpoint.load_checkpoint(path)
    bs = weights.to_jax(model.state_dict())[1]
    weights.load_into(model, saved["model"]["params"], bs)
    opt = trainer.adam(model.parameters(), lr=1e-3)
    checkpoint.load_optimizer_state(opt, model, saved["optimizer"])
    g_sd = weights.from_jax(grads[2], {})
    for n, prm in model.named_parameters():
        prm.grad = g_sd[n].clone()
    opt.step()
    got = weights.to_jax(dict(model.named_parameters()))[0]
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
    # and back: the port's tree of that state has optax's layout
    tree = checkpoint.optimizer_state_tree(opt, model)
    serialization.from_state_dict(st, tree)
    assert int(tree["count"]) == 3


def test_torch_state_dict_import():
    """A reference-named torch state dict built from the port's model: the
    port's convert_state_dict gives dram_tpu's tree, which is the model's
    own (weights.to_jax)."""
    model = DC3DATGeneric(**NARROW)
    params, stats = weights.to_jax(model.state_dict())
    sd = {"dummy": torch.zeros(1)}

    def put(path, a, kind):
        mod, leaf = path[:-1], path[-1]
        a = torch.from_numpy(np.ascontiguousarray(a))
        if leaf == "kernel":
            a = a.permute(4, 3, 0, 1, 2) if a.dim() == 5 else a.T
        name = {"kernel": "weight", "scale": "weight", "bias": "bias",
                "mean": "running_mean", "var": "running_var"}[leaf]
        if mod[0] == "backbone":
            mod = mod[1:]
        head = mod[0]
        if head.startswith(("ds_", "us_")) or head == "bg":
            j = mod[2].rpartition("_")[2]
            lidx = "0" if mod[2].startswith("conv") else "1"
            prefix = "bg" if head == "bg" else \
                f"{head[:2]}_modules.{head[3:]}"
            key = f"{prefix}.conv_blocks.{j}.{lidx}.{name}"
        elif head == "top_layer":
            key = f"top_layer.{name}"
        elif head.startswith("reshape_"):
            key = f"reshape.{head[8:]}.{0 if mod[1] == 'conv' else 1}.{name}"
        else:
            key = f"attention_module.{mod[1]}.{name}"
        sd[key] = a
        if name == "running_var":
            sd[key.replace("running_var", "num_batches_tracked")] = \
                torch.tensor(3)

    def walk(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                put(prefix + (k,), v, None)
    walk(params)
    walk(stats)
    got_p, got_s = torch_import.convert_state_dict(sd)
    want_p, want_s = jtorch_import.convert_state_dict(sd)
    for a, b, c in ((got_p, want_p, params), (got_s, want_s, stats)):
        fa = jax.tree_util.tree_leaves_with_path(a)
        fb = jax.tree_util.tree_leaves_with_path(b)
        fc = jax.tree_util.tree_leaves_with_path(c)
        assert [k for k, _ in fa] == [k for k, _ in fb] == [k for k, _ in fc]
        for (_, x), (_, y), (_, z) in zip(fa, fb, fc):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
    weights.load_into(DC3DATGeneric(**NARROW), got_p, got_s)


def test_load_torch_checkpoint(tmp_path):
    model = _tiny_dc3d()
    sd = {f"top_layer.{k}": v for k, v in
          model.top_layer.state_dict().items()}
    torch.save({"model": sd, "epoch": 3, "iteration": 7},
               tmp_path / "ref.pth")
    state = torch_import.import_torch_checkpoint(
        str(tmp_path / "ref.pth"), str(tmp_path / "ref.ckpt"))
    assert state["epoch"] == 3 and state["iteration"] == 7
    back = checkpoint.load_checkpoint(str(tmp_path / "ref.ckpt"))
    np.testing.assert_array_equal(
        back["model"]["params"]["top_layer"]["bias"],
        model.top_layer.bias.detach().numpy())


@pytest.mark.parametrize("method", ["avg", "global_avg", "global_max"])
def test_pooling_dense_features_matches_jax(method):
    rng = np.random.default_rng(2)
    dense = rng.normal(size=(2, 5, 6, 7, 3)).astype(np.float32)
    lungs = (rng.random((2, 5, 6, 7, 1)) > 0.4).astype(np.float32)
    want = np.asarray(jops.pooling_dense_features(
        jax.numpy.asarray(dense), jax.numpy.asarray(lungs), method))
    got = ops.pooling_dense_features(torch.from_numpy(dense),
                                     torch.from_numpy(lungs), method)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    model = DC3D(pooling_method=method)
    np.testing.assert_array_equal(
        model.pooling_dense_features(torch.from_numpy(dense),
                                     torch.from_numpy(lungs)).numpy(),
        got.numpy())

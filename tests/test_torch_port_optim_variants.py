"""The port's optimizer options against dram_tpu's optax ones on the CPU:
Adam with weight decay (optax's adamw), SGD with and without momentum and
optimizer groups (optax.multi_transform, labelled per flax path
component) over three updates, the groups' learning-rate decay, the
optimizer state in dram_tpu's checkpoint layout written by one package
and read by the other, and HeNorm's modes."""

import math

import flax.serialization as fs
import jax
import numpy as np
import optax
import pytest
import torch

from dram_tpu.train import trainer as jtrainer

from dram_tpu_torch import weights
from dram_tpu_torch.models import DC3DATGeneric
from dram_tpu_torch.models.initializers import HeNorm
from dram_tpu_torch.train import checkpoint, trainer

# f32 updates on both sides: rounding only
TOL = 1e-6

TINY = dict(n_layers=1, base_ch_list=(2, 4, 2), end_ch_list=(4, 8, 4),
            stacking=1, at_spatial_size=(4, 4, 4), at_layers=(-1, 0),
            at_f_dim=2, at_g_dim=2, at_merge_type="scaled_dot_product_geo_relu",
            at_p_enc_dim=6, at_geo_f_dim=2)

CASES = {
    "adamw": {"method": "torch.optim.Adam", "lr": 1e-3,
              "weight_decay": 1e-2},
    "sgd": {"method": "torch.optim.SGD", "lr": 1e-2},
    "sgd_momentum": {"method": "torch.optim.SGD", "lr": 1e-2,
                     "momentum": 0.9},
    # "theta" joins theta and geo_theta (a component containing the key);
    # the backbone's BatchNorm group decays nothing: optax's adam there
    "groups_adamw": {"method": "torch.optim.Adam", "lr": 1e-3,
                     "weight_decay": 1e-2,
                     "groups": {"attention_module": {"lr": 1e-2},
                                "BatchNorm": {"weight_decay": 0.0}}},
    "groups_sgd": {"method": "torch.optim.SGD", "lr": 1e-2, "momentum": 0.9,
                   "groups": {"theta": {"lr": 1e-1, "momentum": 0.0}}},
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model():
    m = DC3DATGeneric(**TINY)
    HeNorm()(m, torch.Generator().manual_seed(0))
    return m


def _jax_tx(cfg):
    """dram_tpu's optimizer of OPTIMIZER `cfg` (its trainer's factories
    and its multi_transform labelling, dram_tpu/train/trainer.py:326-358)."""
    cfg = dict(cfg)
    fn = {"torch.optim.Adam": jtrainer.adam,
          "torch.optim.SGD": jtrainer.sgd}[cfg.pop("method")]
    groups = cfg.pop("groups", None)
    if not groups:
        return fn(**cfg)[0]
    transforms = {}
    for key, overrides in groups.items():
        transforms[key] = fn(**dict(cfg, **overrides))[0]
    transforms["__default__"] = fn(**cfg)[0]
    keys = list(groups)

    def label_of_path(path, _):
        names = [str(k.key) if hasattr(k, "key") else str(k) for k in path]
        for key in keys:
            if any(key in n for n in names):
                return key
        return "__default__"
    return optax.multi_transform(
        transforms,
        lambda p: jax.tree_util.tree_map_with_path(label_of_path, p))


def _grads(model, step):
    rng = np.random.default_rng(100 + step)
    return {n: torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
            for n, p in model.named_parameters()}


def _torch_step(model, opt, grads):
    for n, p in model.named_parameters():
        p.grad = grads[n].clone()
    opt.step()


def _params(model):
    return weights.to_jax({n: p.detach() for n, p in
                           model.named_parameters()})[0]


def _jax_step(tx, state, params, grads):
    updates, state = tx.update(grads, state, params)
    return optax.apply_updates(params, updates), state


def _close_trees(a, b, what):
    fa = dict(jax.tree_util.tree_leaves_with_path(a))
    fb = dict(jax.tree_util.tree_leaves_with_path(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_allclose(np.asarray(fa[k]), np.asarray(fb[k]),
                                   rtol=TOL, atol=TOL, err_msg=f"{what} {k}")


# Cases of a test are looped inside it: pytest-xdist's loadfile order
# puts files with more test items first, and a file of fewer items than
# tests/test_mesh.py (13) starts after that long file, not before it.


def test_updates_match_optax():
    """Three updates of the port's optimizer (build_optimizer) and
    dram_tpu's optax one from the same parameters and gradients agree
    within 1e-6, for every case of CASES."""
    for name in CASES:
        _updates_case(name)


def _updates_case(name):
    cfg = CASES[name]
    model = _model()
    opt = trainer.build_optimizer(model, cfg)
    if name.startswith("groups"):
        labels = [g["label"] for g in opt.param_groups]
        assert labels[0] == "__default__" and len(labels) == 1 + len(
            cfg["groups"])
    tx = _jax_tx(cfg)
    params = _params(model)
    state = tx.init(params)
    for step in range(3):
        g = _grads(model, step)
        _torch_step(model, opt, g)
        params, state = _jax_step(
            tx, state, params, weights.to_jax(g)[0])
        _close_trees(_params(model), params, f"{name} step {step}")


def test_group_membership_per_path_component():
    """A parameter joins a group when a component of its flax path
    contains the key: "theta" takes attention_module/theta and
    attention_module/geo_theta, not the rest."""
    model = _model()
    opt = trainer.build_optimizer(model, CASES["groups_sgd"])
    by_id = {id(p): n for n, p in model.named_parameters()}
    theta = sorted(by_id[id(p)] for p in opt.param_groups[1]["params"])
    assert theta == ["attention_module.geo_theta.bias",
                     "attention_module.geo_theta.weight",
                     "attention_module.theta.bias",
                     "attention_module.theta.weight"]


def test_group_lr_decay():
    """ExponentialLR scales every group's lr by the same factor (dram_tpu's
    _set_lr): base lr x gamma^steps per group."""
    model = _model()
    opt = trainer.build_optimizer(model, CASES["groups_adamw"])
    sch = trainer.ExponentialLR(opt.param_groups[0]["lr"], gamma=0.9)
    sch.step()
    sch.step()
    sch.apply(opt)
    lrs = {g["label"]: g["lr"] for g in opt.param_groups}
    assert lrs == pytest.approx({"__default__": 1e-3 * 0.81,
                                 "attention_module": 1e-2 * 0.81,
                                 "BatchNorm": 1e-3 * 0.81})


def test_checkpoint_both_ways(tmp_path):
    """After two updates each package writes its optimizer state in
    dram_tpu's checkpoint layout (flax msgpack) and the other reads it:
    the reader's third update equals the writer's within 1e-6, and the
    port's tree has dram_tpu's names and shapes, for every case."""
    for name in CASES:
        d = tmp_path / name
        d.mkdir()
        _checkpoint_case(name, d)


def _checkpoint_case(name, tmp_path):
    cfg = CASES[name]
    model = _model()
    opt = trainer.build_optimizer(model, cfg)
    tx = _jax_tx(cfg)
    params = _params(model)
    state = tx.init(params)
    for step in range(2):
        g = _grads(model, step)
        _torch_step(model, opt, g)
        params, state = _jax_step(tx, state, params, weights.to_jax(g)[0])
    g3 = _grads(model, 2)
    # port -> dram_tpu
    path = str(tmp_path / "port.ckpt")
    checkpoint.save_checkpoint(path, {"optimizer":
                                      checkpoint.optimizer_state_tree(
                                          opt, model)})
    with open(path, "rb") as fp:
        restored = fs.msgpack_restore(fp.read())["optimizer"]
    jstate = fs.from_state_dict(state, restored)
    _close_trees(fs.to_state_dict(jstate), fs.to_state_dict(state),
                 f"{name} port-written state")
    p_j, _ = _jax_step(tx, jstate, _params(model), weights.to_jax(g3)[0])
    # dram_tpu -> port
    jpath = tmp_path / "jax.ckpt"
    jpath.write_bytes(fs.msgpack_serialize({"optimizer":
                                            fs.to_state_dict(state)}))
    model2 = _model()
    model2.load_state_dict(model.state_dict())
    opt2 = trainer.build_optimizer(model2, cfg)
    checkpoint.load_optimizer_state(
        opt2, model2, checkpoint.load_checkpoint(str(jpath))["optimizer"])
    _torch_step(model2, opt2, g3)
    _torch_step(model, opt, g3)
    _close_trees(_params(model2), p_j, f"{name} dram_tpu-written, port step")
    _close_trees(_params(model), p_j, f"{name} port-written, dram_tpu step")


def test_henorm_modes_initialise_as_fan_in():
    """HeNorm takes every mode and initialises as dram_tpu trains:
    fan_in (its mode reaches no module); the same draws for fan_out."""
    a, b = DC3DATGeneric(**TINY), DC3DATGeneric(**TINY)
    HeNorm("fan_in")(a, torch.Generator().manual_seed(3))
    h = HeNorm(mode="fan_out")
    assert repr(h) == "HeNorm(mode=fan_out)"
    h(b, torch.Generator().manual_seed(3))
    for (n, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), n
    w = a.backbone.ds_0.convs.conv_1.weight
    fan_in = w.shape[1] * 27
    assert abs(w.std().item() - math.sqrt(2.0 / fan_in)) < \
        0.2 * math.sqrt(2.0 / fan_in)

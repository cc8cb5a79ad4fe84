"""The port's last helpers against dram_tpu's on the CPU: the segmentation
metrics, `masked_bbox` and `stitch_masked` (core/ops.py), the utils
helpers (meters, PD_Stats, dims, `count_params`,
`estimate_conv3d_macs`), `register_alias`, and PROFILE_DIR in the epoch
loop. Tolerances: metrics within 1e-6 relative (float32 on both sides),
everything else exact."""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dram_tpu import utils as jutils
from dram_tpu.configs import st_copd_subtyping as jcopd
from dram_tpu.configs import st_dram_ref as jref
from dram_tpu.configs import st_dram_ref_att as jatt
from dram_tpu.core import ops as jops

from dram_tpu_torch import configs, utils
from dram_tpu_torch.configs import (st_copd_subtyping, st_dram_ref,
                                    st_dram_ref_att)
from dram_tpu_torch.core import ops
from dram_tpu_torch.train.trainer import build_model

from test_torch_port_epochs import _cli, _settings_file


@pytest.fixture(scope="module", autouse=True)
def quiet():
    """One torch intra-op thread; the summary writer's JSON lines instead
    of tensorboard (its import takes ~16 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = sys.modules.get("torch.utils.tensorboard")
    sys.modules["torch.utils.tensorboard"] = None
    yield
    torch.set_num_threads(threads)
    if saved is None:
        del sys.modules["torch.utils.tensorboard"]
    else:
        sys.modules["torch.utils.tensorboard"] = saved


def _masks(seed, shape=(9, 11, 13), p=0.3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=shape) < p).astype(np.uint8)


def test_segmentation_metrics():
    """iou, dice, tpr and fdr against dram_tpu's for overlapping, equal,
    disjoint and empty masks (tpr of an empty target and fdr of an empty
    prediction are inf in both)."""
    a, b = _masks(0), _masks(1)
    z = np.zeros_like(a)
    cases = [(a, b), (a, a), (a, 1 - a), (z, b), (a, z), (z, z),
             (a.astype(np.float32) * 0.7, b.astype(np.int16) * 3)]
    for p, t in cases:
        for name in ("iou", "dice", "tpr", "fdr"):
            got = getattr(ops, name)(torch.from_numpy(p), torch.from_numpy(t))
            want = np.asarray(getattr(jops, name)(jnp.asarray(p),
                                                  jnp.asarray(t)))
            assert got.dtype == torch.float32 and got.ndim == 0, name
            if np.isinf(want):
                assert torch.isinf(got), name
            else:
                np.testing.assert_allclose(got.item(), want, rtol=1e-6,
                                           err_msg=name)
    assert ops.dice(torch.from_numpy(a), torch.from_numpy(a)).item() == 1.0


def test_masked_bbox_and_stitch():
    """masked_bbox gives dram_tpu's int32 starts and stops (an empty mask:
    starts = shape, stops = 0); stitch_masked writes the masked chunk
    into a copy of `full`, negative starts counted from the end and
    clamped as lax.dynamic_slice takes them, as dram_tpu's does."""
    rng = np.random.default_rng(2)
    m = np.zeros((10, 12, 14), np.uint8)
    m[2:5, 7, 3:11] = 1
    for mask in (m, np.zeros_like(m), np.ones_like(m), m[:, :, 3:4]):
        s, e = ops.masked_bbox(torch.from_numpy(mask))
        js, je = jops.masked_bbox(jnp.asarray(mask))
        assert s.dtype == e.dtype == torch.int32
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    s, e = ops.masked_bbox(torch.zeros(4, 5, 6))
    assert s.tolist() == [4, 5, 6] and e.tolist() == [0, 0, 0]
    full = rng.normal(size=(10, 12, 14)).astype(np.float32)
    chunk = rng.normal(size=(4, 5, 6)).astype(np.float32)
    cmask = (rng.uniform(size=(4, 5, 6)) < 0.5).astype(np.uint8)
    for starts in ((0, 0, 0), (3, 4, 5), (6, 7, 8), (9, 11, 13), (-2, 1, 0)):
        ft = torch.from_numpy(full)
        got = ops.stitch_masked(ft, torch.from_numpy(chunk),
                                torch.tensor(starts), torch.from_numpy(cmask))
        want = jops.stitch_masked(jnp.asarray(full), jnp.asarray(chunk),
                                  jnp.asarray(starts), jnp.asarray(cmask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(ft.numpy(), full)  # not in place


def test_utils_helpers(tmp_path):
    """MovingAverage, Timer, PD_Stats (a resumed pickle; the rows equal
    dram_tpu's logger's), expand_dims_np and squeeze_dims_np against
    dram_tpu's."""
    ma, jma = utils.MovingAverage(0.8), jutils.MovingAverage(0.8)
    for v in (1.0, 5.0, -2.0, 0.25):
        ma.update(v)
        jma.update(v)
    assert ma.avg == jma.avg
    ma.reset()
    assert ma.avg == 0.0
    t = utils.Timer()
    time.sleep(0.01)
    assert 0.01 <= t.elapsed() < 5
    cols = ["epoch", "loss", "acc"]
    rows = [[0, 0.5, 0.1], [1, 0.25, 0.4], [2, 0.125, 0.6]]
    for mod, name in ((utils, "port.pkl"), (jutils, "jax.pkl")):
        path = str(tmp_path / name)
        st = mod.PD_Stats(path, cols)
        st.update(rows[0])
        st.update(rows[1])
        st = mod.PD_Stats(path, cols)  # resumed from the pickle
        st.update(rows[2])
    import pandas as pd
    got = pd.read_pickle(str(tmp_path / "port.pkl"))
    pd.testing.assert_frame_equal(got, pd.read_pickle(str(tmp_path /
                                                          "jax.pkl")))
    assert got.values.tolist() == rows
    with pytest.raises(AssertionError):
        utils.PD_Stats(str(tmp_path / "port.pkl"), ["other"])
    a = np.zeros((3, 4))
    for d in (2, 4, 5):
        np.testing.assert_array_equal(utils.expand_dims_np(a, d),
                                      jutils.expand_dims_np(a, d))
    b = np.zeros((1, 1, 3, 1, 4))
    for d, i in ((5, 0), (4, 0), (3, 0)):
        got = utils.squeeze_dims_np(b, d, i)
        assert got.shape == jutils.squeeze_dims_np(b, d, i).shape
    assert utils.squeeze_dims_np(np.zeros((2, 1, 1, 3)), 2, 1).shape == \
        (2, 3)


def test_count_params_and_macs():
    """count_params of the port's flagship (and DC3D) equals dram_tpu's
    over its flax params (drawn with jax.eval_shape); of a nested dict of
    arrays and tensors. estimate_conv3d_macs of the three shipped configs
    at RESAMPLE_SIZE and at 64^3 equals dram_tpu's."""
    x = jnp.zeros((1, 32, 32, 32, 1), jnp.float32)
    for port_cfg, jax_cfg in ((st_dram_ref_att, jatt), (st_dram_ref, jref)):
        with torch.device("meta"):
            model = build_model(port_cfg, torch.float32)
        cfg = dict(jax_cfg.MODEL)
        cls = jutils.get_callable_by_name(cfg.pop("method"))
        v = jax.eval_shape(cls(train=False, **cfg).init,
                           jax.random.PRNGKey(0), x)
        want = jutils.count_params(v["params"])
        assert utils.count_params(model) == want > 10 ** 6
    tree = {"a": np.zeros((3, 4)), "b": {"c": torch.zeros(5),
                                         "d": [np.zeros((2, 2))]}}
    assert utils.count_params(tree) == 21
    for port_cfg, jax_cfg in ((st_dram_ref_att, jatt), (st_dram_ref, jref),
                              (st_copd_subtyping, jcopd)):
        for size in (port_cfg.RESAMPLE_SIZE, (64, 64, 64), (21, 80, 80)):
            assert utils.estimate_conv3d_macs(port_cfg.MODEL, size) == \
                jutils.estimate_conv3d_macs(jax_cfg.MODEL, size)


def test_register_alias():
    """A registered alias resolves through get_callable_by_name; a target
    outside the port still raises."""
    configs.register_alias("models.MyDC3D", "dram_tpu_torch.models.unet3d.DC3D")
    try:
        from dram_tpu_torch.models.unet3d import DC3D
        assert configs.get_callable_by_name("models.MyDC3D") is DC3D
        configs.register_alias("models.Outside", "dram_tpu.models.DC3D")
        with pytest.raises(KeyError):
            configs.get_callable_by_name("models.Outside")
    finally:
        configs._ALIASES.pop("models.MyDC3D", None)
        configs._ALIASES.pop("models.Outside", None)


def test_profile_dir(tmp_path):
    """Two CPU epochs of the tiny DC3D through the CLI: with PROFILE_DIR
    (PROFILE_EPOCH left at its default 1) one Chrome trace, of epoch 1,
    that parses as JSON and holds the step's CPU ops; with PROFILE_EPOCH
    0 one trace of epoch 0; without PROFILE_DIR nothing is written."""
    from dram_tpu.data.prepare_data import make_synthetic_dataset
    db = str(tmp_path / "db")
    make_synthetic_dataset(db, n_scans=3, size=(24, 32, 32), seed=0)
    traces = {}
    for label, extra in (("default", {}), ("epoch 0", {"PROFILE_EPOCH": 0}),
                         ("unset", None)):
        out = str(tmp_path / label.replace(" ", "_"))
        prof = str(tmp_path / f"prof_{label.replace(' ', '_')}")
        kw = {} if extra is None else dict(PROFILE_DIR=prof, **extra)
        smp = _settings_file(tmp_path / f"s_{label.replace(' ', '_')}.py",
                             db, out, **kw)
        runner = _cli(smp)
        assert [e["epoch"] for e in runner.history] == [0, 1]
        traces[label] = sorted(os.listdir(prof)) if os.path.isdir(prof) \
            else []
        profiled = [e["epoch"] for e in runner.history if "trace" in e]
        if extra is None:
            assert traces[label] == [] and profiled == []
            continue
        epoch = extra.get("PROFILE_EPOCH", 1)
        assert traces[label] == [f"epoch_{epoch}_rank_0.trace.json"]
        assert profiled == [epoch]
        with open(os.path.join(prof, traces[label][0])) as fp:
            events = json.load(fp)["traceEvents"]
        names = {e.get("name", "") for e in events}
        assert any("conv3d" in n or "convolution" in n for n in names), \
            sorted(names)[:40]

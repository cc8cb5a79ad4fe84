"""The port's data-parallel training and scan-sharded inference on the
CPU: two TrainSteps of a narrow DC3D on 2 gloo ranks with a padded
batch against dram_tpu's shard_map train step on 2 fake devices (float64)
and against the port's own one-process step on the padded batch; the
training CLI's epoch loop on 2 ranks (only rank 0 writes, a resume is
bitwise); the engine's SHARD_SCANS on the device list [cpu, cpu]; the
kernel build's file lock between two processes. The ranks are processes
of tests/_torch_port_dist_worker.py."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from dram_tpu.losses.refine import IntRegRefineLoss as JaxRefineLoss
from dram_tpu.models import DC3D as JaxDC3D

import _torch_port_dist_worker as worker
from dram_tpu_torch import weights
from dram_tpu_torch.configs import st_dram_ref as cfg
from dram_tpu_torch.core.mesh import pad_batch
from dram_tpu_torch.data.prepare_data import make_synthetic_dataset
from dram_tpu_torch.data.synth import train_batch
from dram_tpu_torch.infer.engine import LesionSegTest
from dram_tpu_torch.losses.refine import IntRegRefineLoss
from dram_tpu_torch.models import DC3D
from dram_tpu_torch.train import trainer
from dram_tpu_torch.train.checkpoint import (load_optimizer_state,
                                             save_checkpoint)
from dram_tpu_torch.train.runner import JobRunner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# st_dram_ref's widths / 8
NARROW = dict(n_layers=3, stacking=3, base_ch_list=(4, 8, 16, 32, 32, 16, 8),
              end_ch_list=(8, 16, 32, 64, 32, 16, 8))
LR = 1e-4


@pytest.fixture(scope="module", autouse=True)
def quiet():
    """One torch intra-op thread, and the summary writer's JSON lines
    (importing tensorboard takes ~16 s)."""
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


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _close(got, want, rel, what):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert set(got) == set(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rel,
                                   atol=rel * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"{what} {k}")


def _jax_dp_step():
    """dram_tpu's data-parallel train step (trainer.py:483-578: the model
    and loss with axis_name, the gradients pmean'd once, optax adam)
    under shard_map on 2 fake devices, in float64 (call it under
    jax.enable_x64)."""
    f64 = jnp.float64
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    jm = JaxDC3D(train=True, dtype=f64, axis_name="data", **NARROW)
    jloss = JaxRefineLoss(**{k: val for k, val in cfg.LOSS_FUNC.items()
                             if k != "method"})
    factors = cfg.LOSS_FACTORS
    tx = optax.adam(LR)

    def step(params, bs, opt_state, images, lobes, lesions, ctss, w, freq):
        def loss_fn(p):
            carry = {"bs": bs}

            def model_fn(im, lo):
                out, mut = jm.apply({"params": p, "batch_stats": carry["bs"]},
                                    im, lo, mutable=["batch_stats"])
                carry["bs"] = mut["batch_stats"]
                return out
            losses = jloss(model_fn, images, lobes, lesions, ctss,
                           ctss_frequency=freq, sample_weight=w,
                           axis_name="data")
            total = sum(l * f for l, f in zip(losses, factors))
            return total, (jnp.stack(losses), carry["bs"])
        (_, (losses, new_bs)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        grads = jax.lax.pmean(grads, "data")
        updates, _ = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), new_bs, losses, grads)

    b, r = P("data"), P()
    return jax.jit(shard_map(step, mesh=mesh,
                             in_specs=(r, r, r, b, b, b, b, b, r),
                             out_specs=(r, r, r, r), check_vma=False))


def _adam_state(tree):
    """optax.adam's state from the port's optimizer_state_tree (optax's
    inject_hyperparams(adam) layout), in float64."""
    inner = tree["inner_state"]["0"]
    mu, nu = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                    (inner["mu"], inner["nu"]))
    return (optax.ScaleByAdamState(count=jnp.asarray(inner["count"]),
                                   mu=mu, nu=nu), optax.EmptyState())


def test_two_dp_train_steps_match_jax_and_one_process(tmp_path):
    """A global batch of 3 padded to 4 (one wrap-around row of weight 0,
    which enters the BatchNorm statistics as in dram_tpu) over 2 ranks,
    two steps: every rank's loss terms, gradients after the cross-rank
    mean, parameters and BatchNorm statistics against dram_tpu's shard_map
    step in float64 (loss terms 1e-4, the rest 5e-3 of each tensor's
    largest value, tests/test_torch_port_train.py's bars) and against the
    port's one-process step on the same padded batch and weights: loss
    terms and BatchNorm statistics within 1e-5 (of each largest value),
    gradients and parameters within 5e-3. Each step starts, on all three
    sides, from rank 0's parameters, statistics and Adam state after the
    step before. The gradients of this step are ill-conditioned in f32:
    the one-process and the data-parallel step each sit ~1e-3 (relative
    L2) from the float64 step, the data-parallel one the closer, and
    ~1.5e-3 from each other, by summation order alone; Adam's step
    lr m / (sqrt(v) + eps) turns that into up to 2 lr on a parameter
    whose gradient is near 0, so a second step taken from each side's own
    first step drifts ~1e-2 apart. The ranks agree bitwise."""
    batch = train_batch(1, batch=3, size=32)
    packed = trainer.pack_train_batch(batch)
    keys = ("images", "lobes", "lesions", "ctss", "span")
    arrays, w = pad_batch(tuple(packed[k] for k in keys), 2)
    packed = dict(packed, **dict(zip(keys, arrays)))
    freq = batch["ctss_frequency"]
    jm32 = JaxDC3D(train=True, **NARROW)
    v = jax.jit(jm32.init)(jax.random.PRNGKey(0),
                           jnp.asarray(packed["images"][:1]))
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    inp = {"init": v, "narrow": NARROW, "lr": LR,
           "factors": cfg.LOSS_FACTORS, "packed": packed, "weights": w,
           "freq": freq}
    got = worker.spawn("train", 2, str(tmp_path), inp)

    # the port's one-process step on the padded batch
    model = weights.load_into(DC3D(**NARROW), v["params"], v["batch_stats"])
    step = trainer.TrainStep(
        model, IntRegRefineLoss(band_width=1e-2, smoothing=0.1),
        trainer.adam(model.parameters(), lr=LR), cfg.LOSS_FACTORS)
    tb = trainer.batch_tensors(dict(packed, weights=w,
                                    ctss_frequency=freq),
                               torch.device("cpu"))
    with jax.enable_x64(True):
        jstep = _jax_dp_step()
        f64 = jnp.float64
        jargs = [jnp.asarray(packed[k], f64) for k in ("images", "lobes",
                                                       "lesions")]
        jargs += [jnp.asarray(packed["ctss"]), jnp.asarray(w, f64),
                  jnp.asarray(freq, f64)]
        start = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, f64), (v["params"], v["batch_stats"]))
        start += (optax.adam(LR).init(start[0]),)
        for it in range(2):
            if it:  # each step from rank 0's state after the step before
                s0 = got[0]["steps"][it - 1]
                weights.load_into(model, s0["params"], s0["batch_stats"])
                load_optimizer_state(step.optimizer, model, s0["opt"])
                start = jax.tree_util.tree_map(
                    lambda a: jnp.asarray(a, f64),
                    (s0["params"], s0["batch_stats"]))
                start += (_adam_state(s0["opt"]),)
            jp, jbs, jl, jg = jstep(*start, *jargs)
            out = step(**tb)
            g1, _ = weights.to_jax({n: p.grad for n, p in
                                    model.named_parameters()})
            p1, bs1 = weights.to_jax(model.state_dict())
            for r, res in enumerate(got):
                s = res["steps"][it]
                what = f"step {it} rank {r}"
                np.testing.assert_allclose(s["losses"], np.asarray(jl),
                                           rtol=1e-4, err_msg=what)
                np.testing.assert_allclose(s["losses"],
                                           out["losses"].numpy(), rtol=1e-5,
                                           err_msg=what)
                _close(s["grads"], jg, 5e-3, f"{what} grad vs JAX")
                _close(s["params"], jp, 5e-3, f"{what} param vs JAX")
                _close(s["batch_stats"], jbs, 5e-3,
                       f"{what} batch_stats vs JAX")
                _close(s["grads"], g1, 5e-3, f"{what} grad vs one process")
                _close(s["params"], p1, 5e-3, f"{what} param vs one process")
                _close(s["batch_stats"], bs1, 1e-5,
                       f"{what} batch_stats vs one process")
            assert worker._tree_equal(got[0]["steps"][it],
                                      got[1]["steps"][it]), it


def test_epoch_loop_on_2_ranks(tmp_path):
    """The training CLI's main on 2 gloo ranks for one epoch, with
    per-rank loading and DP_BATCH_MODE "pad" (global batch 3: rank 1's
    last row is padding), and without per-rank loading in "scale" (2 rows
    a rank, global batch 4): rank 0 writes the checkpoint and
    records.csv and rank 1 nothing; the ranks end with bitwise-equal
    parameters and BatchNorm statistics; a runner reloaded from the
    checkpoint holds the parameters, statistics and Adam state bitwise on
    every rank."""
    db = str(tmp_path / "db")
    make_synthetic_dataset(db, n_scans=3, size=(24, 32, 32), seed=0)
    got = worker.spawn("epochs", 2, str(tmp_path / "ranks"),
                       {"db": db, "out": str(tmp_path)})
    for per_rank in (True, False):
        r0, r1 = got[0][per_rank], got[1][per_rank]
        assert r0["global_batch"] == r1["global_batch"] == \
            (3 if per_rank else 4)
        assert r0["writes"] == ["checkpoint", "records"], per_rank
        assert r1["writes"] == [], per_rank
        assert r0["files"] == r1["files"]
        assert {"0.ckpt", "records.csv", "settings.txt"} <= set(r0["files"])
        assert worker._tree_equal((r0["params"], r0["bs"]),
                                  (r1["params"], r1["bs"]))
        assert r0["reload_equal"] and r1["reload_equal"], per_rank
        assert r0["epoch_losses"] == r1["epoch_losses"]
        assert r0["epoch_losses"] and np.isfinite(r0["epoch_losses"]).all()
        assert r0["val"] == r1["val"] is not None


ENGINE_SETTINGS = textwrap.dedent("""
    DB_PATH = {db!r}
    TEST_CSV = {db!r} + "/wss_all.csv"
    DEBUG_PATH = {out!r} + "/debug/"
    MODEL_ROOT_PATH = {out!r} + "/models/"
    EXP_NAME = "tiny_engine"
    RESAMPLE_MODE = "fixed_size"
    TRAIN_BATCH_SIZE = 2
    RESAMPLE_SPACING = 1.0
    TEST_RESAMPLE_SPACING = 2.0
    RESAMPLE_SIZE = (16, 16, 16)
    LOSS_FACTORS = [2.0, 1.0]
    PAD_VALUE = -2048
    WINDOWING_MAX = -300
    WINDOWING_MIN = -1000
    COMPUTE_DTYPE = "float32"
    RELOAD_CHECKPOINT_PATH = {ckpt!r}
    RELOAD_DICT_LIST = ["model"]
    LOGGING = {{}}
    MODEL = {{"method": "models.DC3D", "n_layers": 2,
              "base_ch_list": [4, 8, 16, 16, 8],
              "end_ch_list": [8, 16, 32, 16, 8], "stacking": 2,
              "out_ch": 1}}
    INITIALIZER = {{"method": "models.HeNorm", "mode": "fan_in"}}
    OPTIMIZER = {{"method": "torch.optim.Adam", "lr": 0.001}}
    LOSS_FUNC = {{"method": "metrics.IntRegRefineLoss",
                  "band_width": 1e-2, "smoothing": 0.1}}
""")


def test_engine_shard_scans_equal_serial(tmp_path):
    """LesionSegTest with SHARD_SCANS = 2 on the device list [cpu, cpu]
    (two scans in flight on two threads, one pipeline for the one device)
    archives the serial run's masks, heatmaps and records bit for bit;
    the host-stitch path and FAST_WIRE = "w8" fall back to serial, and
    -1 takes every device of the list."""
    db, out = str(tmp_path / "db"), str(tmp_path / "out")
    make_synthetic_dataset(db, n_scans=3, size=(24, 32, 32), seed=0)
    ckpt, sfile = str(tmp_path / "1.ckpt"), str(tmp_path / "settings.py")
    with open(sfile, "w") as fp:
        fp.write(ENGINE_SETTINGS.format(db=db, out=out, ckpt=ckpt))
    runner = JobRunner(sfile, device="cpu")
    runner.init()
    with torch.no_grad():  # logits straddling 0: non-empty masks
        runner.model.top_layer.weight.mul_(100.0)
        runner.model.top_layer.bias.mul_(100.0).sub_(1.0)
    params, bs = weights.to_jax(runner.model.state_dict())
    save_checkpoint(ckpt, {"model": {"params": params, "batch_stats": bs},
                           "epoch": 1, "iteration": 10})
    runs = {}
    for n in (0, 2):
        os.environ["DRAM_SHARD_SCANS"] = str(n)
        try:
            eng = LesionSegTest(sfile, output_path=f"{out}/s{n}",
                                device="cpu", devices=["cpu", "cpu"])
            assert eng._shard_count() == max(n, 1)
            runs[n] = (eng.run(), f"{out}/s{n}/test")
        finally:
            del os.environ["DRAM_SHARD_SCANS"]
    assert list(eng._fast_pipes) == [torch.device("cpu")]
    (rows0, d0), (rows2, d2) = runs[0], runs[2]
    assert [r["uid"] for r in rows0] == [r["uid"] for r in rows2]
    assert len(rows0) == 3 and rows0 == rows2
    files = sorted(os.path.relpath(os.path.join(p, f), d0)
                   for p, _, fs in os.walk(d0) for f in fs
                   if f.endswith(".mha"))
    assert len(files) == 9
    masks = 0
    for f in files:
        with open(os.path.join(d0, f), "rb") as a, \
                open(os.path.join(d2, f), "rb") as b:
            assert a.read() == b.read(), f
        masks += os.path.dirname(f) == ""
    assert masks == 3
    with open(f"{d0}/records.csv") as a, open(f"{d2}/records.csv") as b:
        assert a.read() == b.read()
    for kw, n in ((dict(use_fast_path=False), 2),
                  (dict(use_fast_path=True), -1)):
        os.environ["DRAM_SHARD_SCANS"] = str(n)
        try:
            eng = LesionSegTest(sfile, output_path=f"{out}/x", device="cpu",
                                devices=["cpu", "cpu"], **kw)
            assert eng._shard_count() == (1 if n == 2 else 2)
            eng.wire = "w8"
            assert eng._shard_count() == 1
        finally:
            del os.environ["DRAM_SHARD_SCANS"]


RACE = """
import sys, time
from dram_tpu_torch.kernels import _build
_build.BUILD_DIR = sys.argv[1]
out = sys.argv[1] + "/lib.so"

def stub(path):
    with open(sys.argv[1] + "/builds.txt", "a") as fp:
        fp.write(sys.argv[2] + "\\n")
    time.sleep(1.0)
    with open(path, "w") as fp:
        fp.write("built")

_build.ensure_built(out, stub)
print(open(out).read())
"""


def test_kernel_build_is_locked_across_processes(tmp_path):
    """Two processes that race to build the kernels' library (a stub
    build, no nvcc) build it once: the second waits on the file lock and
    finds it built."""
    procs = [subprocess.Popen([sys.executable, "-c", RACE, str(tmp_path),
                               str(i)], cwd=REPO, stdout=subprocess.PIPE,
                              text=True) for i in range(2)]
    outs = [p.communicate(timeout=60)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert [o.strip() for o in outs] == ["built", "built"]
    assert len((tmp_path / "builds.txt").read_text().split()) == 1

"""The port's training epoch loop (train/chunk_train.py) through
`python3 -m dram_tpu_torch.train`'s main on the CPU, at
tests/test_train.py's tiny settings (DC3D, 16^3, batch 2): two epochs
(records.csv in dram_tpu's columns, checkpoints that dram_tpu's loader
and optax's state read), the model in train mode at every step after a
validation, a resume, the same seed giving the same parameters, both
validation paths giving the same labels, the COPDGene configuration, and
unported options raising. dram_tpu's trainer itself is not run (its JAX
compiles take ~100 s): its pieces are held against the port's in
tests/test_torch_port_checkpoints.py and tests/test_torch_port_data.py,
its step in tests/test_torch_port_train.py."""

import os
import shutil
import sys
import textwrap

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from flax import serialization

import dram_tpu.train.checkpoint as jcheckpoint
from dram_tpu.data.prepare_data import make_synthetic_dataset as jmake
from dram_tpu.train import trainer as jtrainer

from dram_tpu_torch import weights
from dram_tpu_torch.data.prepare_data import (make_synthetic_copd_dataset,
                                              make_synthetic_dataset)
from dram_tpu_torch.train.__main__ import main
from dram_tpu_torch.train.checkpoint import load_checkpoint
from dram_tpu_torch.train.chunk_train import LesionSegChunkTrain
from dram_tpu_torch.utils import Settings

# tests/test_train.py's TINY_SETTINGS, with logging to the console only
TINY = textwrap.dedent("""
    DB_PATH = {db!r}
    VALID_CSV = {db!r} + "/val.csv"
    TEST_CSV = {db!r} + "/test.csv"
    DEBUG_PATH = {out!r} + "/debug/"
    MODEL_ROOT_PATH = {out!r} + "/models/"
    JOB_RUNNER_CLS = "job_runner.LesionSegChunkTrain"
    EXP_NAME = "tiny"
    MODEL_NAME = "DC3D"
    RESAMPLE_MODE = "fixed_size"
    NUM_EPOCHS = {epochs}
    VAL_EPOCHS = 1
    STATE_EPOCHS = 1
    NUM_WORKERS = {workers}
    LOG_STEPS = 100
    AUG_RATIO = 0.0
    BALANCED_LABEL_COUNT = 2
    TRAIN_BATCH_SIZE = 2
    RESAMPLE_SPACING = 1.0
    TEST_RESAMPLE_SPACING = 2.0
    RESAMPLE_SIZE = (16, 16, 16)
    LOSS_FACTORS = [2.0, 1.0]
    PAD_VALUE = -2048
    WINDOWING_MAX = -300
    WINDOWING_MIN = -1000
    NR_CLASS = 1
    COMPUTE_DTYPE = "float32"
    RELOAD_CHECKPOINT = False
    RELOAD_CHECKPOINT_PATH = None
    RELOAD_DICT_LIST = ["model", "optimizer", "metrics"]
    LOGGING = {{}}
    MODEL = {{
        "method": "models.DC3D",
        "n_layers": 2,
        "in_ch_list": [1, 8, 16, 48, 24],
        "base_ch_list": [4, 8, 16, 16, 8],
        "end_ch_list": [8, 16, 32, 16, 8],
        "kernel_sizes": [(3, 3)] * 5,
        "stacking": 2,
        "padding_list": [(1, 1)] * 5,
        "checkpoint_layers": [0, 1, 1, 0, 0],
        "dropout": 0.0,
        "out_ch": 1,
    }}
    INITIALIZER = {{"method": "models.HeNorm", "mode": "fan_in"}}
    OPTIMIZER = {{"method": "torch.optim.Adam", "lr": 0.001}}
    SCHEDULER = {{"method": "torch.optim.lr_scheduler.ExponentialLR",
                  "gamma": 0.9}}
    LOSS_FUNC = {{"method": "metrics.IntRegRefineLoss",
                  "band_width": 1e-2, "smoothing": 0.1}}
""")
# the columns of dram_tpu's records.csv (trainer.py:1049-1062: epoch,
# iteration and learning_rate, then the validation and training metrics)
RECORD_COLUMNS = ["epoch", "iteration", "learning_rate", "val_time",
                  "val_acc_reg_cls", "tr_loss", "tr_data_time",
                  "tr_batch_time"]


@pytest.fixture(scope="module", autouse=True)
def quiet():
    """One torch intra-op thread (many small ops, six xdist workers), and
    the summary writer's JSON lines: importing tensorboard takes ~16 s."""
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


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("db"))
    make_synthetic_dataset(root, n_scans=3, size=(24, 32, 32), seed=0)
    return root


def _settings_file(path, db, out, epochs=2, workers=0, **extra):
    text = TINY.format(db=db, out=out, epochs=epochs, workers=workers)
    text += "".join(f"{k} = {v!r}\n" for k, v in extra.items())
    path.write_text(text)
    return str(path)


def _cli(smp, pretrain=0):
    return main([str(pretrain), "0.001", "--batch_size", "2", "--smp", smp,
                 "--device", "cpu"])


@pytest.fixture(scope="module")
def trained(db, tmp_path_factory):
    """Two epochs through the CLI; a forward pre-hook records the model's
    mode and whether grad was on at every forward."""
    tmp = tmp_path_factory.mktemp("run")
    out = str(tmp / "out")
    smp = _settings_file(tmp / "tiny.py", db, out)
    seen = []
    orig = LesionSegChunkTrain.init_training

    def init_training(self):
        orig(self)
        self.model.register_forward_pre_hook(
            lambda m, a: seen.append((m.training, torch.is_grad_enabled())))
    LesionSegChunkTrain.init_training = init_training
    try:
        runner = _cli(smp)
    finally:
        LesionSegChunkTrain.init_training = orig
    return runner, out, os.path.join(out, "models", "tiny"), seen


# -- pieces against dram_tpu ---------------------------------------------


def test_port_checkpoint_loads_in_optax(trained):
    """The port's checkpoint through dram_tpu's loader and flax's
    from_state_dict into optax's adam state built on its parameters: mu,
    nu and count are the port's exp_avg, exp_avg_sq and step."""
    runner, _, exp, _ = trained
    saved = jcheckpoint.load_checkpoint(os.path.join(exp, "1.ckpt"))
    params = saved["model"]["params"]
    tx, _ = jtrainer.adam(lr=1e-3)
    state = serialization.from_state_dict(tx.init(params),
                                          saved["optimizer"])
    inner = state.inner_state[0]
    step = runner.optimizer.state[next(runner.model.parameters())]["step"]
    assert int(state.count) == int(inner.count) == int(step) == 12
    named = dict(runner.model.named_parameters())
    mu = weights.to_jax({n: runner.optimizer.state[p]["exp_avg"]
                         for n, p in named.items()})[0]
    for tree_a, tree_b in ((inner.mu, mu),):
        la = jax.tree_util.tree_leaves(tree_a)
        lb = jax.tree_util.tree_leaves(tree_b)
        assert len(la) == len(lb) == len(named)
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(np.asarray(x), y)
    assert float(state.hyperparams["learning_rate"]) == \
        pytest.approx(1e-3 * 0.9 ** 2)
    assert saved["scheduler"] == runner.scheduler.state_dict()
    assert saved["epoch"] == 1 and saved["iteration"] == 12


# -- the loop through the CLI ------------------------------------------


def test_two_epochs(trained):
    runner, _, exp, _ = trained
    rec = pd.read_csv(os.path.join(exp, "records.csv"))
    assert list(rec.columns) == RECORD_COLUMNS
    assert list(rec["epoch"]) == [0, 1]
    assert np.isfinite(rec["tr_loss"]).all()
    for f in ("0.ckpt", "1.ckpt", "settings.txt"):
        assert os.path.exists(os.path.join(exp, f)), f
    assert runner.scheduler.steps == 2
    base, gamma = runner.scheduler.base_lr, runner.scheduler.gamma
    assert runner.optimizer.param_groups[0]["lr"] == \
        pytest.approx(base * gamma ** 2, rel=1e-12)
    assert rec["learning_rate"].tolist() == pytest.approx([base,
                                                           base * gamma])
    assert runner.epoch_stats["steps"] == 6
    with open(os.path.join(exp, "summary", "scalars.jsonl")) as fp:
        assert len(fp.read().splitlines()) == 4


def test_model_in_train_mode_at_every_step(trained):
    """Validation runs the model in eval mode without grad; every training
    forward after it runs in train mode again (BatchNorm on the batch's
    statistics)."""
    _, _, _, seen = trained
    train = [t for t, g in seen if g]
    val = [t for t, g in seen if not g]
    assert len(train) == 12 and all(train)
    assert len(val) == 2 and not any(val)
    # epoch 0's six steps, its validation, epoch 1's first step
    assert seen[5:8] == [(True, True), (False, False), (True, True)]
    assert seen[-1] == (False, False)


def test_resume(trained, tmp_path):
    """A runner with RELOAD_CHECKPOINT holds the newest checkpoint's
    parameters, BatchNorm buffers, Adam state and scheduler exactly, then
    trains on: the loop starts again at the checkpoint's epoch (as
    dram_tpu's does) and writes 2.ckpt."""
    runner, out, _, _ = trained
    out3 = str(tmp_path / "out")
    shutil.copytree(out, out3)
    exp = os.path.join(out3, "models", "tiny")
    smp = _settings_file(tmp_path / "tiny3.py", runner.settings.DB_PATH,
                         out3, epochs=3, RELOAD_CHECKPOINT=True)
    again = LesionSegChunkTrain(Settings(smp), device="cpu")
    for k, v in runner.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k
    for p, q in zip(runner.model.parameters(), again.model.parameters()):
        a, b = runner.optimizer.state[p], again.optimizer.state[q]
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a[k], b[k]), k
    assert again.scheduler.state_dict() == runner.scheduler.state_dict()
    assert again.epoch_n == 1 and again.current_iteration == 12
    assert again.model_metrics_save_dict.keys() == \
        set(RECORD_COLUMNS[3:])
    again.run()
    assert os.path.exists(os.path.join(exp, "2.ckpt"))
    assert again.scheduler.steps == 4
    rec = pd.read_csv(os.path.join(exp, "records.csv"))
    assert list(rec["epoch"]) == [0, 1, 1, 2]


def test_same_seed_same_parameters(db, trained, tmp_path):
    """The same settings and seed, another output directory, two loader
    threads: the parameters after two epochs are bitwise the same."""
    runner = trained[0]
    other = _cli(_settings_file(tmp_path / "tiny.py", db,
                                str(tmp_path / "out"), workers=2))
    for k, v in runner.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k


def test_validation_paths_agree(trained):
    """The fast path (chunk prep and process_chunks_val) and the
    host-stitch loop give the same ordinal label on each validation
    scan."""
    runner = trained[0]
    runner.model.eval()
    with torch.no_grad():
        for i in range(len(runner.val_dataset)):
            sample = runner.val_dataset[i]
            runner.val_timings = []
            fast_label, target, _ = runner.evaluate_scan(sample)
            runner.settings.VAL_USE_FAST_PIPELINE = False
            try:
                stitch_label, _, _ = runner.evaluate_scan(sample)
            finally:
                runner.settings.VAL_USE_FAST_PIPELINE = True
            ratios = [t["ratio"] for t in runner.val_timings]
            assert fast_label == stitch_label, ratios
            assert "prep_ms" in runner.val_timings[0]
            assert "hoststitch_ms" in runner.val_timings[1]


def test_copd_subtyping_runs(tmp_path):
    """configs/st_copd_subtyping's datasets and CLE sampler at the tiny
    settings, with TRACE tiles and PARAM_LOG_EPOCHS: one epoch trains,
    validates, checkpoints and logs each parameter's histogram."""
    db = str(tmp_path / "copd")
    make_synthetic_copd_dataset(db, n_scans=3, size=(24, 32, 32), seed=0)
    smp = _settings_file(
        tmp_path / "copd.py", db, str(tmp_path / "out"), epochs=1,
        TRAIN_DATASET_CLS="dram_tpu_torch.data.datasets."
                          "COPDGeneSubtypingLobeChunk",
        VAL_DATASET_CLS="dram_tpu_torch.data.datasets.COPDGeneSubtyping",
        SAMPLER_CLS="dram_tpu_torch.data.sampler.LobeChunkCLESampler",
        TRAIN_MEMO_CSV=f"{db}/memo.csv", WINDOWING_MAX=-700, TRACE=True,
        PARAM_LOG_EPOCHS=1)
    runner = _cli(smp)
    assert runner.epoch_stats["steps"] >= 1
    exp = os.path.join(str(tmp_path / "out"), "models", "tiny")
    assert os.path.exists(os.path.join(exp, "0.ckpt"))
    with open(os.path.join(exp, "summary", "histograms.jsonl")) as fp:
        assert len(fp.read().splitlines()) == \
            len(list(runner.model.parameters()))
    assert os.listdir(os.path.join(str(tmp_path / "out"), "debug", "tiny",
                                   "train_trace"))


def test_variant_trains_and_resumes(db, tmp_path):
    """A settings file with options of ROADMAP Queue 1 item 4 trains
    through the CLI on the CPU and resumes: a narrow DC3DATGeneric with
    'in' norms, PReLU, dropout and a k = 5 self-loop PCM of widths 16 /
    4, HeNorm fan_out, Adam with weight decay and an attention_module
    group, IntRegAffRefineLoss with a rescale pool (three loss terms),
    TRACE on (the transform overlay is dumped); the checkpoint holds
    dram_tpu's multi_transform layout and loads back."""
    out = str(tmp_path / "out")
    model = {"method": "models.DC3DATGeneric", "n_layers": 2,
             "base_ch_list": [4, 8, 16, 16, 8],
             "end_ch_list": [8, 16, 32, 16, 8], "stacking": 2,
             "norm_method": "in", "act_method": "prelu", "dropout": 0.1,
             "at_spatial_size": (8, 8, 8), "at_layers": (-1, 0),
             "at_k_size": 5, "at_self_loop": True, "at_f_dim": 16,
             "at_g_dim": 4}
    smp = _settings_file(
        tmp_path / "variant.py", db, out, epochs=1, MODEL=model,
        INITIALIZER={"method": "models.HeNorm", "mode": "fan_out"},
        OPTIMIZER={"method": "torch.optim.Adam", "lr": 1e-3,
                   "weight_decay": 1e-4,
                   "groups": {"attention_module": {"lr": 1e-2}}},
        LOSS_FUNC={"method": "metrics.IntRegAffRefineLoss",
                   "band_width": 1e-2, "smoothing": 0.1,
                   "rescale_jitter": [12, 16, 20]},
        LOSS_FACTORS=[2.0, 1.0, 0.5], TRACE=True)
    runner = _cli(smp)
    assert runner.epoch_stats["steps"] >= 1
    assert all(np.isfinite(runner.epoch_stats["losses"]))
    exp = os.path.join(out, "models", "tiny")
    saved = load_checkpoint(os.path.join(exp, "0.ckpt"))["optimizer"]
    assert sorted(saved["inner_states"]) == ["__default__",
                                             "attention_module"]
    traces = os.path.join(out, "debug", "tiny", "train_trace")
    assert any(os.path.exists(os.path.join(traces, d, "transform.txt"))
               for d in os.listdir(traces))
    again = _cli(smp, pretrain=1)
    assert [g["label"] for g in again.optimizer.param_groups] == \
        ["__default__", "attention_module"]


@pytest.mark.parametrize("extra", [
    {"SCHEDULER": {"method": "torch.optim.Adam"}},
    {"DCN_MESH_SIZE": 2}, {"DP_BATCH_MODE": "scale"},
    {"PER_PROCESS_LOADING": True}, {"TRAIN_WIRE": "bf16"}])
def test_unported_options_raise(db, tmp_path, extra):
    """Options the loop refuses raise; the multi-device options, ported,
    raise only where dram_tpu does: a DCN size that does not divide the
    world (one process here), and a DP_BATCH_MODE other than "pad" and
    "scale"; on one process "scale" keeps the batch and PER_PROCESS_LOADING
    loads it whole (tests/test_torch_port_dist_train.py runs them on 2
    ranks)."""
    smp = _settings_file(tmp_path / "bad.py", db, str(tmp_path / "out"),
                         **extra)
    if "DP_BATCH_MODE" in extra or "PER_PROCESS_LOADING" in extra:
        runner = LesionSegChunkTrain(Settings(smp), device="cpu")
        assert runner.loader_batch_size == 2
        assert runner._loader_row_range is None
        smp = _settings_file(tmp_path / "bad2.py", db,
                             str(tmp_path / "out2"), DP_BATCH_MODE="bogus")
    with pytest.raises((NotImplementedError, ValueError)):
        LesionSegChunkTrain(Settings(smp), device="cpu")


def test_cuda_without_gpu_raises(db, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    smp = _settings_file(tmp_path / "t.py", db, str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--smp", smp])


def test_synthetic_db_matches_jax(db, tmp_path):
    """The dataset this file trains on is dram_tpu's (tests/test_train.py
    makes it with dram_tpu's maker)."""
    other = str(tmp_path / "j")
    jmake(other, n_scans=3, size=(24, 32, 32), seed=0)
    for sub in ("wss_chunk/memo.csv", "wss_chunk/images/p000_s1-1.mha",
                "val.csv"):
        with open(os.path.join(db, sub), "rb") as a, \
                open(os.path.join(other, sub), "rb") as b:
            assert a.read() == b.read(), sub

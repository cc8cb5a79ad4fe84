"""dram_tpu_torch's restartable batch inference (infer/engine.py) and the
modules it runs on, against dram_tpu's on the CPU.

One module fixture writes a synthetic RadboudCOVID layout (three scans of
24 x 32 x 32, one with its lobe 4 removed), a settings file and a
checkpoint of a tiny f32 DC3D saved by dram_tpu: the flax parameters
dram_tpu's runner draws from RANDOM_SEED, the top conv scaled by 100 and
its bias lowered by 1, so that the logits straddle 0 by about +-2, every
lobe predicts a class >= 1 and the masks are not empty.
Then it runs LesionSegTest of both packages
on both paths (fast and host-stitch) over the same files. Both run their
C++ host preps and resamples, which give the same bits on one host.

Tolerances: records.csv's iou, dice, iou_post and dice_post within 5e-3
(the masks may differ by a Dice of 0.005, the repo's mask gate; on these
scans they agree voxel for voxel); acc and the per-lobe classes exactly;
masks at Dice >= 0.995 with the same Otsu bin; heatmaps within one u8
level; headers equal.
"""

import csv
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import dram_tpu.native
from dram_tpu.data import io as jio
from dram_tpu.data.prepare_data import make_synthetic_dataset
from dram_tpu.infer.engine import LesionSegTest as JaxLesionSegTest
from dram_tpu.infer.fast import prep_scan_chunks as jax_prep_scan_chunks
from dram_tpu.train import checkpoint as jckpt
from dram_tpu.train import trainer as jtrainer
from dram_tpu import utils as jutils
from dram_tpu.utils import Settings as JaxSettings

from dram_tpu_torch.configs import st_dram_ref, st_dram_ref_att, with_settings
from dram_tpu_torch.core.ops import binary_cam_np
from dram_tpu_torch.data import io
from dram_tpu_torch.infer.engine import LesionSegTest
from dram_tpu_torch.infer.fast import prep_scan_chunks
from dram_tpu_torch.train import checkpoint as ckpt
from dram_tpu_torch import utils
from dram_tpu_torch.utils import Settings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = (24, 32, 32)
MODEL = dict(method="models.DC3D", n_layers=2,
             in_ch_list=[1, 8, 16, 48, 24], base_ch_list=[4, 8, 16, 16, 8],
             end_ch_list=[8, 16, 32, 16, 8],
             kernel_sizes=[(3, 3)] * 5, stacking=2,
             padding_list=[(1, 1)] * 5, checkpoint_layers=[0] * 5,
             dropout=0.0, out_ch=1)

SETTINGS_TMPL = textwrap.dedent("""
    DB_PATH = {db!r}
    TEST_CSV = {db!r} + "/wss_all.csv"
    DEBUG_PATH = {out!r} + "/debug/"
    MODEL_ROOT_PATH = {out!r} + "/models/"
    JOB_RUNNER_CLS = "job_runner.LesionSegChunkTrain"
    TEST_JOB_RUNNER_CLS = "job_runner.LesionSegTest"
    EXP_NAME = "tiny_engine"
    MODEL_NAME = "DC3D"
    RESAMPLE_MODE = "fixed_size"
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
    RELOAD_CHECKPOINT_PATH = {ckpt!r}
    RELOAD_DICT_LIST = ["model"]
    MODEL = {model!r}
    INITIALIZER = {{"method": "models.HeNorm", "mode": "fan_in"}}
    OPTIMIZER = {{"method": "torch.optim.Adam", "lr": 0.001}}
    SCHEDULER = {{"method": "torch.optim.lr_scheduler.ExponentialLR",
                  "gamma": 0.9}}
    LOSS_FUNC = {{"method": "metrics.IntRegRefineLoss",
                  "band_width": 1e-2, "smoothing": 0.1}}
""")


class _NoSummary:
    def __init__(self, log_dir):
        pass


def _flax_tree(sfile):
    """Flax parameters of the tiny DC3D, seeded as dram_tpu's runner
    seeds them (RANDOM_SEED); the top conv scaled by 100 and its bias
    lowered by 1."""
    runner = jtrainer.JobRunner(settings_module=JaxSettings(sfile))
    runner.init()
    params = jax.tree_util.tree_map(np.asarray, runner.params)
    top = params["top_layer"]
    top["kernel"], top["bias"] = top["kernel"] * 100, top["bias"] * 100 - 1
    return {"params": params,
            "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                  runner.batch_stats)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("engine")
    db, out = str(root / "db"), str(root / "out")
    make_synthetic_dataset(db, n_scans=3, size=SIZE, seed=0)
    # one scan without lobe 4: the `present` flags and the missing-lobe
    # rule of the per-lobe classes
    lobe_file = os.path.join(db, "wss", "lobes", "p001_s1.mha")
    d = jio.read_mha(lobe_file)
    lobe = d["array"].copy()
    lobe[lobe == 4] = 0
    jio.write_mha(lobe_file, lobe, spacing=d["spacing"])
    checkpoint = str(root / "1.ckpt")
    sfile = str(root / "settings.py")
    with open(sfile, "w") as fp:
        fp.write(SETTINGS_TMPL.format(db=db, out=out, ckpt=checkpoint,
                                      model=MODEL))
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        # the runner's scalar logger (training only) would import
        # tensorboard and tensorflow, ~9 s
        mp.setattr(jtrainer, "SummaryWriter", _NoSummary)
        tree = _flax_tree(sfile)
        jckpt.save_checkpoint(checkpoint, {"model": tree, "epoch": 1,
                                           "iteration": 10})
        for path, fast in (("fast", True), ("stitch", False)):
            je = JaxLesionSegTest(settings_module=JaxSettings(sfile),
                                  output_path=f"{out}/jax_{path}",
                                  use_fast_path=fast)
            je.run()
            pe = LesionSegTest(settings_module=sfile,
                               output_path=f"{out}/port_{path}",
                               use_fast_path=fast, device="cpu")
            rows = pe.run()
            runs[path] = {"jax": je, "port": pe, "rows": rows,
                          "jax_dir": f"{out}/jax_{path}/test",
                          "port_dir": f"{out}/port_{path}/test"}
    yield {"db": db, "out": out, "sfile": sfile, "ckpt": checkpoint,
           "runs": runs, "tree": tree}
    torch.set_num_threads(threads)


def _csv(path):
    with open(path, newline="") as fp:
        return list(csv.reader(fp))


def _dice(a, b):
    a, b = a > 0, b > 0
    den = a.sum() + b.sum()
    return 1.0 if den == 0 else 2.0 * np.logical_and(a, b).sum() / den


# --- (a) the engines of both packages -------------------------------------


@pytest.mark.parametrize("path", ["fast", "stitch"])
def test_records_and_lobewise_match(world, path):
    r = world["runs"][path]
    want, got = _csv(f"{r['jax_dir']}/records.csv"), \
        _csv(f"{r['port_dir']}/records.csv")
    assert got[0] == want[0] == ["uid", "iou", "iou_post", "dice",
                                 "dice_post", "acc"]
    assert [g[0] for g in got] == [w[0] for w in want]
    assert len(got) == 4
    for g, w in zip(got[1:], want[1:]):
        for k, name in enumerate(got[0][1:], 1):
            if name == "acc":
                assert float(g[k]) == float(w[k]), (g[0], name)
            else:
                assert abs(float(g[k]) - float(w[k])) <= 5e-3, (g[0], name)
    assert [row["uid"] for row in r["rows"]] == [w[0] for w in want[1:]]
    lw_want, lw_got = _csv(f"{r['jax_dir']}/lobewise.csv"), \
        _csv(f"{r['port_dir']}/lobewise.csv")
    assert lw_got == lw_want
    assert lw_got[0] == ["", "target", "pred"] and len(lw_got) == 16
    preds = [int(row[2]) for row in lw_got[1:]]
    assert min(preds) >= 1


@pytest.mark.parametrize("path", ["fast", "stitch"])
def test_archived_masks_match(world, path):
    r = world["runs"][path]
    nonempty = []
    for uid in ("p000_s1", "p001_s1", "p002_s1"):
        lung = io.read_mha(os.path.join(world["db"], "wss", "lobes",
                                        f"{uid}.mha"))["array"] > 0
        files = {}
        for sub in ("", "post/", "heatmap/"):
            a = jio.read_mha(f"{r['jax_dir']}/{sub}{uid}.mha")
            b = io.read_mha(f"{r['port_dir']}/{sub}{uid}.mha")
            assert b["array"].shape == SIZE and b["array"].dtype == np.uint8
            for k in ("spacing", "origin", "direction"):
                assert tuple(a[k]) == tuple(b[k]), (sub, uid, k)
            files[sub] = (a["array"], b["array"])
        nonempty.append(files[""][1].any())
        for sub in ("", "post/"):
            assert _dice(*files[sub]) >= 0.995, (sub, uid)
        heat = [h.astype(int) for h in files["heatmap/"]]
        assert np.abs(heat[0] - heat[1]).max() <= 1, uid
        bins = [round(binary_cam_np(h[lung] / 255.0)[1] * 255) for h in heat]
        assert bins[0] == bins[1], uid
    assert any(nonempty)


# --- (b) the MHA codec ----------------------------------------------------


@pytest.mark.parametrize("ext", [".mha", ".mhd"])
@pytest.mark.parametrize("compress", [True, False])
def test_mha_codec_bytes_and_cross_read(tmp_path, ext, compress):
    rng = np.random.default_rng(1)
    arr = rng.integers(-1024, 1500, (7, 9, 11)).astype(np.int16)
    header = dict(spacing=(1.25, 0.7, 0.65), origin=(-10.5, 3.0, 7.25),
                  direction=[0, 0, 1, 0, -1, 0, 1, 0, 0])
    jio.write_mha(str(tmp_path / f"jax{ext}"), arr, compress=compress,
                  **header)
    io.write_mha(str(tmp_path / f"port{ext}"), arr, compress=compress,
                 **header)
    data = ".zraw" if compress else ".raw"
    pairs = [(f"jax{ext}", f"port{ext}")]
    if ext == ".mhd":
        pairs.append((f"jax{data}", f"port{data}"))
    for a, b in pairs:
        ta, tb = (tmp_path / a).read_bytes(), (tmp_path / b).read_bytes()
        if a.endswith(".mhd"):
            ta = ta.replace(b"jax" + data.encode(), b"port" + data.encode())
        assert ta == tb, a
    for reader, name in ((io.read_mha, "jax"), (jio.read_mha, "port")):
        d = reader(str(tmp_path / f"{name}{ext}"))
        np.testing.assert_array_equal(d["array"], arr)
        assert d["array"].dtype == arr.dtype
        assert d["spacing"] == header["spacing"]
        assert d["origin"] == header["origin"]
        assert d["direction"] == [float(v) for v in header["direction"]]


def test_write_array_to_mha_itk_same_bytes(tmp_path):
    arr = (np.arange(4 * 5 * 6).reshape(4, 5, 6) % 3).astype(np.float32)
    kw = dict(type=np.uint8, spacing=(2.0, 1.0, 0.5), origin=(1, 2, 3))
    jio.write_array_to_mha_itk(str(tmp_path / "j"), [arr], ["x"], **kw)
    io.write_array_to_mha_itk(str(tmp_path / "p"), [arr], ["x"], **kw)
    assert (tmp_path / "j" / "x.mha").read_bytes() == \
        (tmp_path / "p" / "x.mha").read_bytes()


# --- (c) checkpoints --------------------------------------------------------


def _tree_equal(a, b):
    assert isinstance(a, dict) == isinstance(b, dict), (a, b)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _tree_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_checkpoints_round_trip_between_packages(world, tmp_path):
    tree = {"model": world["tree"], "epoch": 7, "iteration": 12345,
            "metrics": {"dice": 0.5, "best": np.float32(0.25)},
            "scheduler": {"steps": 3, "base_lr": 1e-4, "gamma": 0.9}}
    ckpt.save_checkpoint(str(tmp_path / "port.ckpt"), tree)
    jckpt.save_checkpoint(str(tmp_path / "jax.ckpt"), tree)
    assert (tmp_path / "port.ckpt").read_bytes() == \
        (tmp_path / "jax.ckpt").read_bytes()
    _tree_equal(jckpt.load_checkpoint(str(tmp_path / "port.ckpt")), tree)
    _tree_equal(ckpt.load_checkpoint(str(tmp_path / "jax.ckpt")), tree)


def test_newest_checkpoint_ranking(tmp_path):
    assert ckpt.newest_checkpoint(str(tmp_path)) is None
    for name in ("best.ckpt", "3.ckpt", "latest.ckpt", "12.ckpt", "9.ckpt"):
        (tmp_path / name).write_bytes(b"")
    want = jckpt.newest_checkpoint(str(tmp_path))
    assert ckpt.newest_checkpoint(str(tmp_path)) == want
    assert want.endswith("12.ckpt")
    for name in ("3.ckpt", "12.ckpt", "9.ckpt"):
        os.remove(tmp_path / name)
    assert ckpt.newest_checkpoint(str(tmp_path)) == \
        jckpt.newest_checkpoint(str(tmp_path))


def test_tolerant_merge_drops_the_same_keys():
    current = {"a": {"kernel": np.zeros((3, 2), np.float32),
                     "bias": np.zeros(2, np.float32)},
               "b": {"scale": np.ones(4, np.float32)},
               "c": np.zeros(1, np.float32), "n": 1}
    saved = {"a": {"kernel": np.ones((3, 2), np.float64),
                   "bias": np.ones(3, np.float32)},
             "b": {"scale": np.full(4, 2.0, np.float32)},
             "extra": np.ones(2), "n": 5}
    logs = {"jax": [], "port": []}
    want = jckpt.tolerant_merge(current, saved, ignored_keys=("b/scale",),
                                log=logs["jax"].append)
    got = ckpt.tolerant_merge(current, saved, ignored_keys=("b/scale",),
                              log=logs["port"].append)
    _tree_equal(got, want)
    assert logs["port"] == logs["jax"] and len(logs["port"]) == 2
    assert ckpt.tolerant_merge(current, saved, overwrite=True).keys() == \
        jckpt.tolerant_merge(current, saved, overwrite=True).keys()


# --- (d) port-only runs -----------------------------------------------------


def test_restart_skips_archived_scans(world):
    r = world["runs"]["fast"]
    out = os.path.dirname(r["port_dir"])
    before = _csv(f"{r['port_dir']}/records.csv")
    eng = LesionSegTest(settings_module=world["sfile"], output_path=out,
                        device="cpu")
    rows = eng.run()
    assert eng.test_set.uids == [] and eng.timings == []
    assert _csv(f"{r['port_dir']}/records.csv") == before
    assert [row["uid"] for row in rows] == [b[0] for b in before[1:]]


def _deploy_dirs(world, root, mha=("p000_s1", "p002_s1"), mhd=("p001_s1",)):
    """Copies of synthetic scans and lobes as a deployment directory: the
    `mha` uids as they are, the `mhd` ones in the two-file layout."""
    scans, lobes = root / "ct", root / "lobes"
    for src, dst in (("images", scans), ("lobes", lobes)):
        dst.mkdir()
        for uid in mha:
            shutil.copy(os.path.join(world["db"], "wss", src, f"{uid}.mha"),
                        dst)
        for uid in mhd:
            d = io.read_mha(os.path.join(world["db"], "wss", src,
                                         f"{uid}.mha"))
            io.write_mha(str(dst / f"{uid}.mhd"), d["array"],
                         spacing=d["spacing"], origin=d["origin"],
                         direction=d["direction"])
    return str(scans), str(lobes)


def test_deployment_mode_without_references(world, tmp_path):
    scans, lobes = _deploy_dirs(world, tmp_path)
    eng = LesionSegTest(settings_module=world["sfile"], scan_path=scans,
                        lobe_path=lobes, output_path=str(tmp_path / "out"),
                        device="cpu")
    rows = eng.run()
    assert [row["uid"] for row in rows] == ["p000_s1", "p001_s1", "p002_s1"]
    assert all(list(row) == ["uid"] for row in rows)
    task = tmp_path / "out" / "test"
    assert _csv(task / "records.csv") == [["uid"], ["p000_s1"], ["p001_s1"],
                                          ["p002_s1"]]
    assert not (task / "lobewise.csv").exists()
    for row in rows:
        for sub in ("", "post/", "heatmap/"):
            a = io.read_mha(str(task / f"{sub}{row['uid']}.mha"))["array"]
            assert a.shape == SIZE
    # the scans are not masked in deployment mode, but the model sees
    # each lobe's voxels only: the fast path's pred matches the scored run
    scored = world["runs"]["fast"]["port_dir"]
    for uid in ("p000_s1", "p002_s1"):
        a = io.read_mha(str(task / f"{uid}.mha"))["array"]
        b = io.read_mha(f"{scored}/{uid}.mha")["array"]
        assert _dice(a, b) >= 0.995, uid


def test_truncated_scan_fails_alone(world, tmp_path, caplog):
    """The last scan's file is cut short: it is logged and missing, the
    others are archived, and records.csv holds their rows (written after
    the loop, since the last scan wrote none)."""
    scans, lobes = _deploy_dirs(world, tmp_path)
    path = os.path.join(scans, "p002_s1.mha")
    with open(path, "rb") as fp:
        data = fp.read()
    with open(path, "wb") as fp:
        fp.write(data[:len(data) - 200])
    eng = LesionSegTest(settings_module=world["sfile"], scan_path=scans,
                        lobe_path=lobes, output_path=str(tmp_path / "out"),
                        device="cpu")
    with caplog.at_level("ERROR"):
        rows = eng.run()
    assert [row["uid"] for row in rows] == ["p000_s1", "p001_s1"]
    task = tmp_path / "out" / "test"
    assert not (task / "p002_s1.mha").exists()
    assert (task / "p000_s1.mha").exists() and (task / "p001_s1.mha").exists()
    assert _csv(task / "records.csv") == [["uid"], ["p000_s1"], ["p001_s1"]]
    assert any("Cannot process scan 2 (p002_s1)" in m
               for m in caplog.messages)


@pytest.mark.parametrize("setting,value,devices", [
    pytest.param("SHARD_SCANS", 2, 1, id="SHARD_SCANS-2-Queue 1 item 5")])
def test_unported_options_raise(world, tmp_path, setting, value, devices):
    """SHARD_SCANS was unported (it raised NotImplementedError); now
    ported, it is taken and clamped to the engine's device list as
    dram_tpu clamps it to the local devices: one CPU device, serial
    (tests/test_torch_port_dist_train.py runs two scans in flight)."""
    settings = with_settings(Settings(world["sfile"]), **{setting: value})
    eng = LesionSegTest(settings_module=settings,
                        output_path=str(tmp_path), device="cpu")
    assert len(eng.devices) == devices
    assert eng._shard_count() == min(value, devices)


def test_unknown_fast_wire_raises(world, tmp_path):
    settings = with_settings(Settings(world["sfile"]), FAST_WIRE="p12")
    with pytest.raises(ValueError, match="one of"):
        LesionSegTest(settings_module=settings,
                      output_path=str(tmp_path), device="cpu")


def test_w8_wire_archives_masks(world, tmp_path, monkeypatch):
    """FAST_WIRE = "w8" (prep_scan's windowed 8-bit scan, then
    process_prepped) in both packages: every scan archived with its
    scores; the port's masks equal dram_tpu's w8 masks at Dice >= 0.995
    and its pred masks are within the w8 wire's gate of its chunk-wire
    run (Dice > 0.98, tests/test_fast_infer.py); prep and device stages
    timed. (The post masks of these 24 x 32 x 32 scans move further
    between the wires, in dram_tpu alike: Dice 0.961 on p002_s1.)"""
    monkeypatch.setattr(jtrainer, "SummaryWriter", _NoSummary)
    jax_settings = JaxSettings(world["sfile"])
    jax_settings.FAST_WIRE = "w8"
    JaxLesionSegTest(settings_module=jax_settings,
                     output_path=str(tmp_path / "jax")).run()
    settings = with_settings(Settings(world["sfile"]), FAST_WIRE="w8")
    eng = LesionSegTest(settings_module=settings,
                        output_path=str(tmp_path / "port"), device="cpu")
    rows = eng.run()
    assert [row["uid"] for row in rows] == ["p000_s1", "p001_s1", "p002_s1"]
    assert all(np.isfinite(row["dice"]) for row in rows)
    wc_dir = world["runs"]["fast"]["port_dir"]
    nonempty = []
    for uid in ("p000_s1", "p001_s1", "p002_s1"):
        for sub in ("", "post/"):
            got = io.read_mha(str(tmp_path / "port" / "test" /
                                  f"{sub}{uid}.mha"))["array"]
            want = jio.read_mha(str(tmp_path / "jax" / "test" /
                                    f"{sub}{uid}.mha"))["array"]
            assert got.shape == SIZE and got.dtype == np.uint8
            assert _dice(got, want) >= 0.995, (sub, uid)
            nonempty.append(got.any())
        wc = io.read_mha(f"{wc_dir}/{uid}.mha")["array"]
        pred = io.read_mha(str(tmp_path / "port" / "test" /
                               f"{uid}.mha"))["array"]
        assert _dice(pred, wc) > 0.98, uid
        assert (tmp_path / "port" / "test" / "heatmap" /
                f"{uid}.mha").exists()
    assert any(nonempty)
    assert [t["uid"] for t in eng.timings] == \
        ["p000_s1", "p001_s1", "p002_s1"]
    assert all({"prep", "pre", "model", "post"} <= set(t)
               for t in eng.timings)


def test_cuda_request_without_gpu_raises(world, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LesionSegTest(settings_module=world["sfile"],
                      output_path=str(tmp_path))


def test_cli_runs_on_the_cpu(world, tmp_path):
    scans, lobes = _deploy_dirs(world, tmp_path, mha=("p002_s1",), mhd=())
    out = tmp_path / "out"
    r = subprocess.run(
        [sys.executable, "-m", "dram_tpu_torch.process_pipeline",
         "--input", scans, "--lobes", lobes, "--output", str(out),
         "--smp", world["sfile"], "--ckp_path", world["ckpt"],
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert _csv(out / "test" / "records.csv") == [["uid"], ["p002_s1"]]
    for sub in ("", "post/", "heatmap/"):
        assert (out / "test" / f"{sub}p002_s1.mha").exists()


# --- (e) the present flags ------------------------------------------------


def test_process_chunks_returns_present(world):
    """The port's process_chunks returns the prep's per-lobe flags, as
    dram_tpu's does, on the scan without lobe 4."""
    r = world["runs"]["fast"]
    s = Settings(world["sfile"])
    d = io.read_mha(os.path.join(world["db"], "wss", "images",
                                 "p001_s1.mha"))
    lobe = io.read_mha(os.path.join(world["db"], "wss", "lobes",
                                    "p001_s1.mha"))["array"]
    scan = d["array"].copy()
    scan[lobe == 0] = -2048
    args = (scan, lobe, d["spacing"], s.TEST_RESAMPLE_SPACING,
            s.PAD_VALUE, None, (s.WINDOWING_MIN, s.WINDOWING_MAX),
            tuple(s.RESAMPLE_SIZE))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dram_tpu.native, "hostprep_native", None, raising=False)
        want = r["jax"]._fast().process_chunks(jax_prep_scan_chunks(*args),
                                               want_heatmap=True)
    got = r["port"]._fast().process_chunks(
        prep_scan_chunks(*args, prep="numpy"), want_heatmap=True)
    np.testing.assert_array_equal(got["present"],
                                  np.asarray(want["present"]))
    np.testing.assert_array_equal(got["present"], [1, 1, 1, 0, 1])


# --- (f) the port's settings ------------------------------------------------

# every setting the engine, its runner and the fast pipeline read
ENGINE_KEYS = ("EXP_NAME", "DB_PATH", "TEST_CSV", "DEBUG_PATH",
               "MODEL_ROOT_PATH", "RELOAD_CHECKPOINT",
               "RELOAD_CHECKPOINT_PATH", "RELOAD_DICT_LIST",
               "RESAMPLE_MODE", "RESAMPLE_SPACING", "TEST_RESAMPLE_SPACING",
               "RESAMPLE_SIZE", "PAD_VALUE", "WINDOWING_MIN",
               "WINDOWING_MAX", "JOB_RUNNER_CLS", "TEST_JOB_RUNNER_CLS",
               "MODEL", "INITIALIZER", "COMPUTE_DTYPE", "LOGGING")


@pytest.mark.parametrize("module", [st_dram_ref, st_dram_ref_att],
                         ids=["st_dram_ref", "st_dram_ref_att"])
def test_config_copies_hold_the_jax_values(module, monkeypatch):
    monkeypatch.delenv("DRAM_COMPUTE_DTYPE", raising=False)
    name = module.__name__.rsplit(".", 1)[1]
    want = JaxSettings(os.path.join(REPO, "dram_tpu", "configs",
                                    f"{name}.py"))
    got = Settings(module.__file__)
    assert Settings(module).MODEL == got.MODEL
    for key in ENGINE_KEYS:
        assert getattr(got, key) == getattr(want, key), key
    for key in ("USE_FAST_INFERENCE", "FAST_WIRE", "SHARD_SCANS"):
        assert not got.is_overridden(key) and not want.is_overridden(key)


def test_csv_and_settings_helpers_match(world):
    csv_file = os.path.join(world["db"], "wss_all.csv")
    for key in ("patientid", "lul [0-5]"):
        assert utils.read_csv_in_dict(csv_file, key) == \
            jutils.read_csv_in_dict(csv_file, key)
    assert utils.read_csv_in_dict_double(csv_file, ["patientid", "study"]) \
        == jutils.read_csv_in_dict_double(csv_file, ["patientid", "study"])
    assert utils.read_csv_in_dict(csv_file + ".missing", "uid") == ({}, None)
    log = st_dram_ref_att.LOGGING
    assert utils.get_value_recursively(log, "filename") == \
        jutils.get_value_recursively(log, "filename") != []
    got, want = Settings(world["sfile"]), JaxSettings(world["sfile"])
    assert str(got) == str(want)
    assert str(Settings(with_settings(got, EXP_NAME="x"))) == \
        str(got).replace("EXP_NAME:tiny_engine", "EXP_NAME:x")
    meter = utils.AverageMeter()
    for v in (1.0, 2.0, 6.0):
        meter.update(v)
    assert (meter.val, meter.avg, meter.count) == (6.0, 3.0, 3)

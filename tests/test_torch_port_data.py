"""The port's training data layer against dram_tpu's on the CPU: the
synthetic dataset makers (the same bytes in every file), the chunk
datasets (arrays bit for bit, meta equal), the CTSS sampler (sequence
and statistics), the threaded loader with the wire packing (batches bit
for bit at 0 and 2 workers, both wires), the five training
augmentations under one np.random seed, and the properties of the CLE
sampler's stratified order (dram_tpu's calls sklearn without a seed)."""

import filecmp
import logging
import os

import numpy as np
import pytest
import torch

from dram_tpu.data import datasets as jdatasets
from dram_tpu.data import pipeline as jpipeline
from dram_tpu.data import prepare_data as jprepare
from dram_tpu.data import sampler as jsampler
from dram_tpu.data import transforms as JT
from dram_tpu.train import trainer as jtrainer

from dram_tpu_torch.data import datasets, pipeline, prepare_data, sampler
from dram_tpu_torch.data import transforms as T
from dram_tpu_torch.train import trainer

SIZE = (24, 32, 32)
CHUNK = (16, 16, 16)
WINDOW = (-1000, -300)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one torch intra-op thread (six xdist workers share
    the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """Both packages' synthetic RadboudCOVID layouts, 3 scans, seed 0."""
    out = {}
    for name, mod in (("port", prepare_data), ("jax", jprepare)):
        db = str(tmp_path_factory.mktemp(f"db_{name}"))
        out[name] = (db, mod.make_synthetic_dataset(db, n_scans=3, size=SIZE,
                                                    seed=0))
    return out


def _same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    files = []
    for dirpath, _, names in os.walk(a):
        for n in names:
            rel = os.path.relpath(os.path.join(dirpath, n), a)
            files.append(rel)
            with open(os.path.join(a, rel), "rb") as fa, \
                    open(os.path.join(b, rel), "rb") as fb:
                assert fa.read() == fb.read(), rel
    assert not cmp.left_only and not cmp.right_only
    return files


def test_synthetic_dataset_same_bytes(dbs):
    (pdb, pinfo), (jdb, jinfo) = dbs["port"], dbs["jax"]
    assert pinfo == jinfo
    files = _same_tree(pdb, jdb)
    assert sum(f.endswith(".mha") for f in files) == 3 * 4 + 3 * 5 * 3
    assert {"wss_all.csv", "wss_train.csv", "val.csv", "test.csv",
            os.path.join("wss_chunk", "memo.csv")} <= set(files)


def test_synthetic_copd_dataset_same_bytes(tmp_path):
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    assert prepare_data.make_synthetic_copd_dataset(a, 3, SIZE, 0) == \
        jprepare.make_synthetic_copd_dataset(b, 3, SIZE, 0)
    files = _same_tree(a, b)
    assert "memo.csv" in files and os.path.join("meta", "ctss.csv") in files


def test_prepare_data_cli(tmp_path, capsys):
    prepare_data.main(["--synthetic", str(tmp_path), "--n_scans", "1",
                       "--size", *map(str, SIZE)])
    assert "1 scans, 5 chunks" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        prepare_data.main([])


def _chunk_sets(db):
    uids = datasets.RadboudCOVIDLobeVesselChunk.get_series_uids(
        f"{db}/wss_chunk/memo.csv")
    return (datasets.RadboudCOVIDLobeVesselChunk(db, uids),
            jdatasets.RadboudCOVIDLobeVesselChunk(db, uids))


def _same_sample(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_chunk_dataset_samples_equal(dbs):
    db = dbs["port"][0]
    ours, ref = _chunk_sets(db)
    assert ours.uids == ref.uids and len(ours) == 15
    for i in range(len(ours)):
        a, b = ours[i], ref[i]
        _same_sample(a, b)
        assert a["meta"]["ctss"] == a["meta"]["cle"] == a["ctss"]
        assert a["#pseudo_lesion_reference"].any()


def test_copd_datasets_equal(tmp_path):
    db = str(tmp_path)
    prepare_data.make_synthetic_copd_dataset(db, 3, SIZE, 0)
    uids = datasets.COPDGeneSubtypingLobeChunk.get_series_uids(
        f"{db}/memo.csv")
    ours = datasets.COPDGeneSubtypingLobeChunk(db, uids)
    ref = jdatasets.COPDGeneSubtypingLobeChunk(db, uids)
    for i in range(len(ours)):
        _same_sample(ours[i], ref[i])
    scans = datasets.COPDGeneSubtyping.get_series_uids(f"{db}/val.csv")
    a = datasets.COPDGeneSubtyping(db, scans)[0]
    b = jdatasets.COPDGeneSubtyping(db, scans)[0]
    _same_sample(a, b)
    assert a["#lesion_reference"].any()


@pytest.mark.parametrize("seed", [33, 33 + 9973])
def test_ctss_sampler_equal(dbs, seed):
    ours, ref = _chunk_sets(dbs["port"][0])
    log = logging.getLogger("test")
    a = sampler.LobeChunkCTSSSampler(log, ours, 2, balance_label_count=3,
                                     seed=seed)
    b = jsampler.LobeChunkCTSSSampler(log, ref, 2, balance_label_count=3,
                                      seed=seed)
    assert list(a) == list(b) and len(a) == len(b)
    assert a.class_weights == b.class_weights
    assert a.ctss_frequency_map == b.ctss_frequency_map
    np.testing.assert_array_equal(a.frequency_array(), b.frequency_array())
    c = sampler.LobeChunkCTSSSampler(None, ours, 2, seed=seed)
    d = jsampler.LobeChunkCTSSSampler(None, ref, 2, seed=seed)
    assert list(c) == list(d)


def _transforms(mod):
    return mod.Compose([
        mod.Windowing(min=WINDOW[0], max=WINDOW[1]),
        mod.Resample(mode="fixed_size", factor=1.0, size=CHUNK),
        mod.ensemble_augmentation(0.0), mod.RemoveMeta()])


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("wire", ["f32", "u16"])
def test_loader_batches_equal(dbs, workers, wire):
    """The trainer's training transforms (windowing, the C++ resample to
    the chunk size, augmentation at ratio 0, RemoveMeta), the loader and
    pack_train_batch give dram_tpu's batches bit for bit."""
    db = dbs["port"][0]
    ours, ref = _chunk_sets(db)
    ours.transforms = _transforms(T)
    ref.transforms = _transforms(JT)
    got = []
    for ds, smod, pmod, tmod in ((ours, sampler, pipeline, trainer),
                                 (ref, jsampler, jpipeline, jtrainer)):
        smp = smod.LobeChunkCTSSSampler(None, ds, 2, balance_label_count=2,
                                        seed=5)
        loader = pmod.DataLoader(
            ds, smp, batch_size=2, num_workers=workers,
            collate_fn=lambda s, m=pmod, t=tmod: t.pack_train_batch(
                m.collate_dict(s), wire))
        got.append(list(loader))
        assert len(loader) == len(got[-1]) == len(smp) // 2
    for a, b in zip(*got):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["images"].shape == (2, *CHUNK, 1)
    raw = pipeline.collate_dict([ours[0], ours[1]])
    assert raw["meta"]["uid"] == (ours.uids[0], ours.uids[1])
    assert set(raw["meta"]) <= set(T.RemoveMeta.KEEP)


def test_loader_row_range_raises(dbs):
    """DataLoader(row_range) was unported (it raised); now ported: each
    index batch is cut to rows [lo, hi) as dram_tpu's loader cuts it, the
    batches the full batches' rows lo..hi-1, bit for bit."""
    ours, ref = _chunk_sets(dbs["port"][0])
    ours.transforms = _transforms(T)
    ref.transforms = _transforms(JT)
    got = {}
    for name, ds, mod in (("port", ours, pipeline), ("jax", ref, jpipeline)):
        for rows in (None, (1, 3), (2, 4)):
            loader = mod.DataLoader(ds, range(8), 4, num_workers=0,
                                    row_range=rows)
            got[name, rows] = list(loader)
            assert len(loader) == 2
    for rows in ((1, 3), (2, 4)):
        for whole, part, jpart in zip(got["port", None], got["port", rows],
                                      got["jax", rows]):
            np.testing.assert_array_equal(
                part["#image"], whole["#image"][rows[0]:rows[1]])
            np.testing.assert_array_equal(part["#image"], jpart["#image"])
            assert part["meta"]["uid"] == jpart["meta"]["uid"]


def _aug_sample(seed=3):
    rng = np.random.default_rng(seed)
    return {"#image": rng.normal(size=(12, 14, 16)).astype(np.float32),
            "#lobe_reference": (rng.random((12, 14, 16)) > 0.5)
            .astype(np.uint8),
            "meta": {"uid": "x", "spacing": (1.0, 1.0, 1.0)}}


AUGS = {"blur": lambda m: m.GaussianBlur((0.3, 0.5), "random"),
        "noise": lambda m: m.GaussianAddictive((0.01, 0.02)),
        "mask_out": lambda m: m.RandomMaskOut(
            region_range=((0.2, 0.8),) * 3, region_size=((0.1, 0.3),) * 3),
        "flip": lambda m: m.RandomFlip(3),
        "rotate": lambda m: m.RandomRotate90(3),
        "ensemble_0": lambda m: m.ensemble_augmentation(0.0),
        "ensemble_1": lambda m: m.ensemble_augmentation(1.0)}


@pytest.mark.parametrize("name", sorted(AUGS))
def test_augmentations_equal(name):
    outs = []
    for mod in (T, JT):
        np.random.seed(11)
        t = AUGS[name](mod)
        outs.append([t(_aug_sample(s)) for s in range(3)])
    changed = False
    for s, (a, b) in enumerate(zip(*outs)):
        _same_sample(a, b)
        changed |= not np.array_equal(a["#image"], _aug_sample(s)["#image"])
    assert changed == (name != "ensemble_0")


class _CLEData:
    def __init__(self, labels):
        self.uids = [f"u{i}" for i in range(len(labels))]
        self.meta = {u: {"cle": str(c)} for u, c in zip(self.uids, labels)}


@pytest.mark.parametrize("seed", [0, 7])
def test_cle_sampler_properties(seed):
    """dram_tpu's balanced picks come from the seeded generator and are
    equal; its stratified order calls sklearn without a seed, so the
    port's order is held to the procedure's properties: n_splits groups
    of test_size, each with its labels' proportional counts within one,
    the same order for the same seed."""
    labels = [0] * 9 + [1] * 4 + [3] * 6 + [5] * 2
    data = _CLEData(labels)
    a = sampler.LobeChunkCLESampler(None, data, 2, balance_label_count=5,
                                    seed=seed)
    rng = np.random.default_rng(seed)
    ref_picks = [int(i) for l in (0, 1, 3, 5) for i in
                 rng.choice(np.where(np.asarray(labels) == l)[0], 5)]
    assert a.balanced_picks == ref_picks
    try:
        b = jsampler.LobeChunkCLESampler(None, data, 2,
                                         balance_label_count=5, seed=seed)
    except ImportError:
        b = None  # dram_tpu's sampler needs sklearn
    if b is not None:
        assert a.class_weights == b.class_weights
        assert a.ctss_frequency_map == b.ctss_frequency_map
        assert sorted(b.indices) != [] and len(b) == len(a)
    test_size, n = 4, 20
    assert len(a) == (n // test_size) * test_size
    picked = [labels[i] for i in a.indices]
    for g in range(n // test_size):
        counts = np.bincount(picked[g * test_size:(g + 1) * test_size],
                             minlength=6)
        for l in (0, 1, 3, 5):
            assert abs(counts[l] - test_size * 5 / n) <= 1
    again = sampler.LobeChunkCLESampler(None, data, 2, balance_label_count=5,
                                        seed=seed)
    assert again.indices == a.indices
    np.testing.assert_array_equal(a.frequency_array()[[2, 4]],
                                  np.float32([1e-5, 1e-5]))

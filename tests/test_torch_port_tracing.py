"""The port's tracer (dram_tpu_torch.tracing) on the CPU: off, a scan and
a training step record nothing and open no profiler range or CUDA event;
under torch.profiler they record their span trees, one unit a scan or a
step, with the spans below the unit as top-level `dram.*` ranges of the
profiler's timeline and the counted host-to-device copies; the pipeline's
`stage_ms` and the step's `ms` keep their keys; a PROFILE_DIR epoch's
trace holds the ranges."""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from dram_tpu_torch import tracing
from dram_tpu_torch.configs import st_dram_ref_att as att
from dram_tpu_torch.data.prepare_data import make_synthetic_dataset
from dram_tpu_torch.data.synth import synth_scan, train_batch
from dram_tpu_torch.infer import fast
from dram_tpu_torch.models import DC3DATGeneric
from dram_tpu_torch.train import trainer

from test_torch_port_epochs import _cli, _settings_file

SPAN = (-1000, -700)
CHUNK = (16, 16, 16)
NARROW = dict(base_ch_list=(4, 8, 8, 16, 16, 8, 8),
              end_ch_list=(8, 8, 16, 16, 16, 8, 8),
              at_spatial_size=(8, 8, 8), at_f_dim=4, at_g_dim=4)
# host-to-device copies of one process_chunks(unpack=False) call without
# the heatmap: pre 12 (chunks, lobe bits, unpack shifts, 9 forward
# tables), post 13 (9 backward tables, crop offsets and sizes, presence,
# the pack weights)
H2D_HOT = 25
STEP_SPANS = ("unpack", "loss", "backward", "optimizer")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def clean():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture(scope="module")
def pipe_prep():
    torch.manual_seed(0)
    pipe = fast.FastScanPipeline(DC3DATGeneric(**NARROW).eval(),
                                 device="cpu", chunk_size=CHUNK,
                                 windowing_span=SPAN)
    scan, lobe, _, _, _ = synth_scan(np.random.default_rng(3), (24, 40, 36))
    prep = fast.prep_scan_chunks(scan, lobe, (1.6, 0.8, 0.9),
                                 windowing_span=SPAN, chunk_size=CHUNK,
                                 prep="numpy")
    assert list(prep["present"]) == [1, 1, 1, 1, 1]
    return pipe, prep


@pytest.fixture(scope="module")
def step_feed():
    """A TrainStep of the flagship at narrow widths (f32, 16^3) and one
    batch on the CPU's f32 wire."""
    class Narrow:
        pass
    s = Narrow()
    for k in dir(att):
        if k.isupper():
            setattr(s, k, getattr(att, k))
    s.MODEL = dict(att.MODEL, **NARROW)
    s.COMPUTE_DTYPE = "float32"
    step = trainer.build_train_step(s, "cpu")
    return step, trainer.batch_tensors(train_batch(5, 2, 16), "cpu")


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _guard(monkeypatch):
    """record_function raises for the program's ranges, torch.cuda.Event
    and the tracer's Span for every call."""
    real = torch.autograd.profiler.record_function

    def record_function(name, *a, **k):
        if str(name).startswith("dram."):
            raise AssertionError(f"range {name} opened")
        return real(name, *a, **k)

    def boom(*a, **k):
        raise AssertionError("created while the tracer is off")
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        record_function)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(tracing.Span, "__init__", boom)


def test_off_records_nothing(pipe_prep, step_feed, monkeypatch):
    """No profiler and no forcing: a scan and a timed=False step open no
    range, create no CUDA event and no span, and leave the record
    empty."""
    pipe, prep = pipe_prep
    step, feed = step_feed
    _guard(monkeypatch)
    assert not tracing.on()
    res = pipe.process_chunks(prep, unpack=False)
    out = step(**feed, timed=False)
    assert "stage_ms" not in res and out["ms"] is None
    assert tracing.snapshot() == {"spans": [], "units": [], "counters": {}}


def test_scan_spans_under_profiler(pipe_prep):
    """Two scans under torch.profiler: a `scan` unit each with its own
    id, pre / model / post below it (the PCM inside the model, the
    uploads inside pre and post), the counted copies, and the spans as
    `dram.*` ranges whose top level holds the stages and no `dram.scan`."""
    pipe, prep = pipe_prep
    with _cpu_profile() as prof:
        for _ in range(2):
            pipe.process_chunks(prep, unpack=False)
    snap = tracing.snapshot()
    units = snap["units"]
    assert [u["name"] for u in units] == ["scan", "scan"]
    assert len({u["unit"] for u in units}) == 2
    assert [u["counters"] for u in units] == [{"h2d_copies": H2D_HOT}] * 2
    assert snap["counters"] == {"h2d_copies": 2 * H2D_HOT}
    by_id = {s["id"]: s for s in snap["spans"]}
    for u in units:
        mine = [s for s in snap["spans"] if s["unit"] == u["unit"]]
        kids = [s["name"] for s in mine if s["parent"] == u["unit"]]
        assert kids == ["pre", "model", "post"]
        for s in mine:
            if s["name"] == "h2d":
                assert by_id[s["parent"]]["name"] in ("pre", "post")
            if s["name"] == "pcm":
                assert by_id[s["parent"]]["name"] == "model"
        assert sum(s["name"] == "h2d" for s in mine) == H2D_HOT
        root = by_id[u["unit"]]
        assert all(root["t0"] <= s["t0"] <= s["t1"] <= root["t1"]
                   for s in mine)
    events = list(prof.events())
    top = {e.name for e in events if e.cpu_parent is None}
    names = {e.name for e in events}
    assert {"dram.pre", "dram.model", "dram.post"} <= top
    assert {"dram.h2d", "dram.pcm"} <= names - top
    assert "dram.scan" not in names
    assert not tracing.on()


def test_step_spans_under_profiler(step_feed):
    """A timed=False step under torch.profiler: one `step` unit with
    unpack / loss / backward / optimizer below it, the model's calls
    inside the loss and the PCM inside the model; the stages are
    top-level `dram.*` ranges, with no `dram.step`."""
    step, feed = step_feed
    with _cpu_profile() as prof:
        out = step(**feed, timed=False)
    assert out["ms"] is None
    snap = tracing.snapshot()
    assert [u["name"] for u in snap["units"]] == ["step"]
    uid = snap["units"][0]["unit"]
    spans = snap["spans"]
    assert all(s["unit"] == uid for s in spans)
    by_id = {s["id"]: s for s in spans}
    assert tuple(s["name"] for s in spans if s["parent"] == uid) \
        == STEP_SPANS
    models = [s for s in spans if s["name"] == "model"]
    assert models and all(by_id[s["parent"]]["name"] == "loss"
                          for s in models)
    pcms = [s for s in spans if s["name"] == "pcm"]
    assert pcms and all(by_id[s["parent"]]["name"] == "model" for s in pcms)
    assert all(s["device_ms"] == s["host_ms"] for s in spans
               if s["name"] != "step")
    names = {e.name for e in prof.events()}
    top = {e.name for e in prof.events() if e.cpu_parent is None}
    assert {f"dram.{n}" for n in STEP_SPANS} <= top
    assert "dram.step" not in names and "dram.model" in names - top


def test_stage_ms_keys(pipe_prep, monkeypatch):
    """unpack=True returns stage_ms with its keys (host ms on the CPU)
    on both paths, opens no profiler range without a profiler, and
    leaves the tracer off."""
    pipe, prep = pipe_prep
    real = torch.autograd.profiler.record_function

    def record_function(name, *a, **k):
        assert not str(name).startswith("dram."), name
        return real(name, *a, **k)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        record_function)
    for heat in (False, True):
        res = pipe.process_chunks(prep, want_heatmap=heat)
        assert set(res["stage_ms"]) == {"pre", "model", "post"}
        assert all(isinstance(v, float) and v >= 0.0
                   for v in res["stage_ms"].values())
    assert not tracing.on()
    assert [u["name"] for u in tracing.snapshot()["units"]] == ["scan"] * 2


def test_step_ms_keys(step_feed):
    """timed=True returns ms with its keys, the loss, backward and
    optimizer spans' times, and leaves the tracer off."""
    step, feed = step_feed
    out = step(**feed, timed=True)
    assert set(out["ms"]) == {"forward", "backward", "optimizer"}
    spans = {s["name"]: s for s in tracing.snapshot()["spans"]}
    assert out["ms"] == {"forward": spans["loss"]["device_ms"],
                         "backward": spans["backward"]["device_ms"],
                         "optimizer": spans["optimizer"]["device_ms"]}
    assert not tracing.on()


def test_recording_and_bound(monkeypatch):
    """recording() turns the tracer on without opening ranges; counters
    outside a unit add to the totals only; the record keeps the last
    MAX_SPANS spans."""
    monkeypatch.setattr(tracing, "_spans",
                        tracing.collections.deque(maxlen=3))
    assert tracing.span("x") is tracing.span("y")  # the off singleton
    with tracing.recording():
        assert tracing.on()
        tracing.count("c", 2)
        with tracing.unit("u") as u:
            with tracing.span("a", "cpu"):
                tracing.count("c")
            for name in ("b", "c"):
                with tracing.span(name):
                    pass
    assert not tracing.on()
    snap = tracing.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["u", "b", "c"]
    assert snap["units"] == [{"unit": u.id, "name": "u",
                              "host_ms": u.host_ms, "counters": {"c": 1}}]
    assert snap["counters"] == {"c": 3}
    assert u.device_ms_of("a") is not None and u.device_ms_of("b") is None


def test_units_in_threads():
    """Forced units and counts from more threads than cores, with a short
    switch interval: every unit recorded with its own counts, the totals
    whole, and the tracer off again once all are done."""
    n_threads, n_units = 4 * (os.cpu_count() or 1), 50
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(n_units):
            with tracing.unit("scan", force=True):
                with tracing.span("pre"):
                    tracing.count("h2d_copies")
                tracing.count("h2d_copies", 2)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert not tracing.on()
    snap = tracing.snapshot()
    assert len(snap["units"]) == n_threads * n_units
    assert all(u["counters"] == {"h2d_copies": 3} for u in snap["units"])
    assert snap["counters"] == {"h2d_copies": 3 * n_threads * n_units}
    units = {u["unit"] for u in snap["units"]}
    assert all(s["unit"] in units and s["parent"] == s["unit"]
               for s in snap["spans"] if s["name"] == "pre")


def test_profile_dir_trace_holds_spans(tmp_path):
    """One CPU epoch of the tiny DC3D through the CLI, profiled
    (PROFILE_DIR, PROFILE_EPOCH 0): its Chrome trace holds the step's
    `dram.*` ranges and no `dram.step`."""
    db = str(tmp_path / "db")
    make_synthetic_dataset(db, n_scans=3, size=(24, 32, 32), seed=0)
    prof = str(tmp_path / "prof")
    smp = _settings_file(tmp_path / "s.py", db, str(tmp_path / "out"),
                         epochs=1, PROFILE_DIR=prof, PROFILE_EPOCH=0)
    _cli(smp)
    with open(os.path.join(prof, "epoch_0_rank_0.trace.json")) as fp:
        names = {e.get("name", "") for e in json.load(fp)["traceEvents"]}
    assert {f"dram.{n}" for n in STEP_SPANS + ("model",)} <= names
    assert "dram.step" not in names

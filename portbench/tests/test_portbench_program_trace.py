"""The readers of the program's own spans and counters
(dram_tpu_torch.tracing): dispatch_ms.infer, model_dispatch_ms.infer,
h2d_syncs.infer, h2d_wait_ms.infer, loss_ms.train and pcm_ms.train, on a
synthetic record, on a program without the tracer, and in traced runs
of the tiny cells on the CPU."""

import sys

import pytest

import dram_tpu_torch
from dram_tpu_torch import tracing
from portbench import run as bench_run
from portbench.lib import harness

from ._tiny import tiny

INFER = ("dispatch_ms.infer", "model_dispatch_ms.infer", "h2d_syncs.infer",
         "h2d_wait_ms.infer")
TRAIN = ("loss_ms.train", "pcm_ms.train")
CTX = {"prof": {"units": 2}}


def _span(i, name, unit, parent, host_ms=0.0, device_ms=None):
    return {"id": i, "name": name, "unit": unit, "parent": parent,
            "t0": 0.0, "t1": host_ms / 1e3, "host_ms": host_ms,
            "device_ms": device_ms}


def _record():
    """Two scans and two steps; a span outside any unit and an `h2d`
    count outside a scan, which no reader may count."""
    spans, units = [], []
    for u, host in ((1, 30.0), (20, 26.0)):
        units.append({"unit": u, "name": "scan", "host_ms": host,
                      "counters": {"h2d_copies": 25}})
        spans += [_span(u, "scan", u, None, host),
                  _span(u + 1, "pre", u, u, 3.0, 1.0),
                  _span(u + 2, "h2d", u, u + 1, 0.5),
                  _span(u + 3, "model", u, u, 12.0, 9.0),
                  _span(u + 4, "post", u, u, 8.0, 4.0),
                  _span(u + 5, "h2d", u, u + 4, 1.5)]
    for u, extra in ((40, 0.0), (60, 2.0)):
        units.append({"unit": u, "name": "step", "host_ms": 200.0,
                      "counters": {}})
        spans += [_span(u, "step", u, None, 200.0),
                  _span(u + 1, "loss", u, u, 90.0, 80.0 + extra),
                  _span(u + 2, "model", u, u + 1, 50.0, 60.0),
                  _span(u + 3, "pcm", u, u + 2, 5.0, 7.0 + extra),
                  _span(u + 4, "model", u, u + 1, 20.0, 10.0),
                  _span(u + 5, "backward", u, u, 90.0, 95.0)]
    spans += [_span(99, "h2d", None, None, 40.0),
              _span(98, "model", None, None, 40.0, 40.0)]
    return {"spans": spans, "units": units,
            "counters": {"h2d_copies": 51}}


def test_readers_on_a_synthetic_record(monkeypatch):
    monkeypatch.setattr(tracing, "snapshot", _record)
    got = {n: harness.read_metric(n, CTX) for n in INFER + TRAIN}
    assert got == {"dispatch_ms.infer": pytest.approx(28.0),
                   "model_dispatch_ms.infer": pytest.approx(12.0),
                   "h2d_syncs.infer": pytest.approx(25.0),
                   "h2d_wait_ms.infer": pytest.approx(2.0),
                   "loss_ms.train": pytest.approx(11.0),
                   "pcm_ms.train": pytest.approx(8.0)}


@pytest.mark.parametrize("name", INFER + TRAIN)
def test_nothing_to_read(name, monkeypatch):
    """None without a profiled part, without units, with a device time
    not yet resolved (the training readers), and in a program without
    the tracer (an older program)."""
    assert harness.read_metric(name, {"prof": None}) is None
    monkeypatch.setattr(tracing, "snapshot", lambda: {
        "spans": [], "units": [], "counters": {}})
    assert harness.read_metric(name, CTX) is None
    if name in TRAIN:
        rec = _record()
        for s in rec["spans"]:
            if s["name"] in ("loss", "pcm"):
                s["device_ms"] = None
        monkeypatch.setattr(tracing, "snapshot", lambda: rec)
        assert harness.read_metric(name, CTX) is None
    monkeypatch.delattr(dram_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "dram_tpu_torch.tracing", None)
    assert harness.read_metric(name, CTX) is None


def _traced(workload, **traffic):
    over = tiny(workload)
    over["traffic"].update(profile_after_s=0.0, **traffic)
    tracing.reset()
    try:
        res, _ = bench_run.run_cell(workload, 7, 3.0, 1, "cpu",
                                    overrides=over)
    finally:
        tracing.reset()
    return res


def test_traced_tiny_scans():
    """A traced run of the tiny inference cell: the four readers report;
    the copies are the hot path's count; the host ms a scan, inside the
    model and in the copies fit inside the profiled part's host ms a
    scan."""
    res = _traced("infer.att.mixed512", profile_scans=2)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(INFER) <= set(m)
    assert m["h2d_syncs.infer"] == 25
    per_scan_ms = 1e3 * res["device"]["window_s"] / 2
    assert 0 < m["dispatch_ms.infer"] <= per_scan_ms
    assert m["model_dispatch_ms.infer"] + m["h2d_wait_ms.infer"] \
        <= m["dispatch_ms.infer"]


@pytest.mark.parametrize("workload", ["train.att.b10", "train.dc3d.b10"])
def test_traced_tiny_steps(workload):
    """A traced run of a tiny training cell: loss_ms.train in both,
    pcm_ms.train where the model has a PCM (host times on the CPU)."""
    res = _traced(workload, profile_steps=1)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["loss_ms.train"] > 0
    if workload == "train.att.b10":
        assert m["pcm_ms.train"] > 0
    else:
        assert "pcm_ms.train" not in m

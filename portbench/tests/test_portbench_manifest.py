"""BENCHMARK.json and every file it names load, and keep to the
benchmark's contract (keys, names, bounds, lengths)."""

import json
import os
import re

from portbench.lib import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_and_named_files_load():
    b = harness.manifest()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        with open(os.path.join(harness.ROOT, c["file"])) as fp:
            assert json.load(fp)["name"] == c["name"]
    used = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        _, cfg, traffic, limits = harness.cell(w["name"], b)
        assert traffic["kind"] in ("scan_infer", "train_step") and limits
        used.add(w["config"])
        for m in harness.metrics_of(b, w["name"], 0):
            assert m["source"] in ("host_clock", "device_trace")
        assert any(m["name"] == "setup_s"
                   for m in harness.metrics_of(b, w["name"], 0))
        assert len(harness.metrics_of(b, w["name"], 0)) >= 2
        assert harness.metrics_of(b, w["name"], 1)
    assert used == set(configs)
    names = [x["name"] for x in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(harness.PORTBENCH, "metrics",
                                           m["name"] + ".py"))
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}

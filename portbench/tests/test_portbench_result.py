"""The result line's shape, the import guard, and the exit without a
card."""

import ast
import json
import os
import subprocess
import sys

import pytest

from portbench import run as bench_run
from portbench.lib import harness

from ._tiny import tiny


def test_last_line_shape():
    res, lines = bench_run.run_cell("train.dc3d.b10", 3, 0.5, 0, "cpu",
                                    overrides=tiny("train.dc3d.b10"))
    line = json.loads(json.dumps(res))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert set(line["metrics"]) == {"train_chunks_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for k, v in line["checks"].items():
        assert set(v) == {"value", "limit"}
    assert [ln.split(":")[0] for ln in lines] == \
        [f"check {k}" for k in line["checks"]]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_import_guard():
    """No module of portbench imports jax, jaxlib, flax or dram_tpu (top-
    level names compared whole: dram_tpu_torch is the program); the
    reference imports nothing of dram_tpu_torch."""
    for d, _, files in os.walk(harness.PORTBENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & set(harness.BANNED), (path, tops)
            if os.sep + "reference" + os.sep in path:
                assert "dram_tpu_torch" not in tops, path
    assert "dram_tpu" not in [
        m.split(".")[0] for m in ["dram_tpu_torch.infer.fast"]]


def test_no_card_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, os.path.join(harness.PORTBENCH,
                                                     "run.py"),
                        "--workload", "train.dc3d.b10", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=harness.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.card
def test_cell_on_the_card(card):
    """One short run of each cell on the card: correct, with its
    metrics (run on the card: python -m pytest portbench/tests -m card)."""
    b = harness.manifest()
    for w in b["workloads"]:
        for trace in (0, 1):
            p = subprocess.run(
                [sys.executable, os.path.join(harness.PORTBENCH, "run.py"),
                 "--workload", w["name"], "--seed", "12345",
                 "--seconds", "8", "--trace", str(trace)],
                capture_output=True, text=True, cwd=harness.ROOT)
            assert p.returncode == 0, p.stderr[-3000:]
            line = json.loads(p.stdout.strip().splitlines()[-1])
            assert line["correct"], line["checks"]
            want = {m["name"] for m in harness.metrics_of(b, w["name"],
                                                          trace)}
            assert set(line["metrics"]) == want

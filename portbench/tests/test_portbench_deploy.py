"""The engine's fast path through the `scan_deploy` driver at a size the
CPU holds: a sound run agrees with the reference on the scan grid and
reads the engine's host clock, the faults and the control come out not
correct, and on the card the control fails the cell's committed
limits.

Seeded tiny weights give every lobe one label, and on some seeds empty
masks; SEED's masks are not empty (30,196 voxels in its first scan),
so every run here compares voxels."""

import numpy as np
import pytest
import torch

from portbench import calibrate
from portbench import run as bench_run
from portbench.lib import harness, scan_deploy
from portbench.reference import scan_grid

from ._tiny import tiny

CELL = "infer.att.deploy512"
SEED = 2 ** 31 + 5


@pytest.mark.parametrize("workload", [CELL, "infer.att.mixed512"])
def test_sound_run_agrees_on_masks(workload):
    """Both scan cells on a seed with masks: the C++ prep's rounding
    moves a few voxels at the Otsu cut, within the tiny limits."""
    nums = {}
    res, lines = bench_run.run_cell(workload, SEED, 0.5, 0, "cpu",
                                    overrides=tiny(workload), numbers=nums)
    assert res["correct"], lines
    assert res["failed"] == 0 and res["attempted"] > 0
    assert nums["pred_diff"] > 0, nums
    if workload == CELL:
        assert set(res["metrics"]) == {"scans_per_min", "setup_s"}


def test_traced_run_reads_the_engine():
    """A traced run reports the engine's prep and its own host work
    (every scan of the window), and the pipeline's readers of the port's
    tracer (the profiled scans)."""
    from dram_tpu_torch import tracing
    over = tiny(CELL)
    over["traffic"].update(profile_after_s=0.0, profile_scans=2)
    tracing.reset()
    try:
        res, lines = bench_run.run_cell(CELL, SEED, 3.0, 1, "cpu",
                                        overrides=over)
    finally:
        tracing.reset()
    assert res["correct"], lines
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert {"prep_ms.deploy", "engine_ms.deploy", "dispatch_ms.infer",
            "model_dispatch_ms.infer", "h2d_syncs.infer",
            "h2d_wait_ms.infer"} <= set(m), m
    assert m["prep_ms.deploy"] > 0 and m["engine_ms.deploy"] > 0
    per_scan_ms = 1e3 * res["device"]["window_s"] / 2
    assert 0 < m["dispatch_ms.infer"] <= per_scan_ms
    assert m["model_dispatch_ms.infer"] + m["h2d_wait_ms.infer"] \
        <= m["dispatch_ms.infer"]


@pytest.mark.parametrize("fault", ["alter_answer", "half_batch"])
def test_fault_is_not_correct(fault):
    res, lines = bench_run.run_cell(CELL, SEED, 0.5, 0, "cpu", fault=fault,
                                    overrides=tiny(CELL))
    assert res["correct"] is False, lines


def test_control_fails():
    o = tiny(CELL)
    got = calibrate.readings(o["config"], o["traffic"], SEED,
                             torch.device("cpu"))
    assert set(got) == {"control_fp8", "fault_half_batch"}
    for what, nums in got.items():
        assert not harness.checks_line(nums, o["limits"])[1], (what, nums)


def test_scan_grid_and_labels_by_hand():
    iso = torch.zeros(3, 2, 2, dtype=torch.bool)
    iso[1, 1, 0] = True
    # spacing 0.5 of a 1.0 iso grid: scan voxel j reads iso floor(j/2 +
    # 0.5); voxels past the iso grid read False
    out = scan_grid.on_scan_grid(iso, (6, 4, 2), (0.5, 0.5, 1.0), 1.0)
    want = torch.zeros(6, 4, 2, dtype=torch.bool)
    want[1:3, 1:3, 0] = True
    assert torch.equal(out, want)
    assert scan_grid.labels([0.0, 0.0005, 0.001, 0.2, 0.5, 1.2]) == \
        [0, 0, 1, 3, 5, 5]
    mine = {"pred": want.numpy().astype(np.uint8),
            "post": np.zeros((6, 4, 2), np.uint8), "labels": [3, 0],
            "ratios": [0.36, 0.0], "present": [1, 1]}
    ref = {"pred": want, "post": want, "ratios": np.array([0.35, 0.0])}
    g = scan_deploy.gaps(mine, ref)
    assert g["pred_diff"] == 0.0 and g["post_diff"] == 1.0
    assert g["ratio_gap"] == pytest.approx(0.01)
    # 0.36 is class 4: one label wrong
    assert g["label_err"] == 1.0
    mine.update(labels=[0], present=[0, 1])
    assert scan_deploy.gaps(mine, ref)["label_err"] == 0.0


@pytest.mark.card
def test_control_fails_the_cells_limits(card):
    """At the cell's own size on the card: the control (the reference in
    fp8 in the program's place) and half of each scan's chunks left out,
    read in the reference's place, are rejected by the committed
    limits."""
    _, cfg, traffic, limits = harness.cell(CELL)
    for seed in (2 ** 31 + 11, 2 ** 32 + 3):
        got = calibrate.readings(cfg, traffic, seed, card)
        for what, nums in got.items():
            assert harness.checks_line(nums, limits)[1] is False, \
                (seed, what, nums)
        torch.cuda.empty_cache()

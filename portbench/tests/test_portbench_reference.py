"""The reference against the port at a size the CPU holds (float32 on
both sides): the networks' forward, three training steps through the
cells' own driver, and scans through the inference cell's driver; and
the control (the reference in fp8 in the program's place) reads far
above the sound readings."""

import pytest
import torch

from portbench import calibrate
from portbench import run as bench_run
from portbench.lib import build, harness
from portbench.reference import nets

from ._tiny import tiny

SEED = 2 ** 31 + 77


@pytest.mark.parametrize("workload", ["train.att.b10", "train.dc3d.b10"])
def test_forward_matches_the_port(workload):
    cfg = tiny(workload)["config"]
    model, state = build.model_and_state(cfg, SEED, torch.device("cpu"))
    x = torch.rand(2, 16, 16, 16, 1)
    for train in (False, True):
        model.train(train)
        with torch.no_grad():
            dense, refined = model(x)
            rd, rr = nets.forward(x.permute(0, 4, 1, 2, 3), state,
                                  cfg["values"]["MODEL"], train)
        assert torch.allclose(dense, rd.permute(0, 2, 3, 4, 1),
                              atol=1e-4, rtol=1e-4)
        assert torch.allclose(refined, rr.permute(0, 2, 3, 4, 1),
                              atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("workload", ["train.att.b10", "train.dc3d.b10",
                                      "infer.att.mixed512"])
def test_sound_program_agrees(workload):
    res, lines = bench_run.run_cell(workload, SEED, 0.5, 0, "cpu",
                                    overrides=tiny(workload))
    assert res["correct"], lines
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("workload", ["train.att.b10", "train.dc3d.b10",
                                      "infer.att.mixed512"])
def test_control_fails(workload):
    """The control and the fault read in the reference's place fail the
    tiny cell's limits (calibrate.readings, the comparison of a run)."""
    o = tiny(workload)
    got = calibrate.readings(o["config"], o["traffic"], SEED,
                             torch.device("cpu"))
    for what, nums in got.items():
        assert not harness.checks_line(nums, o["limits"])[1], (what, nums)


@pytest.mark.card
@pytest.mark.parametrize("workload", ["train.att.b10", "train.dc3d.b10",
                                      "infer.att.mixed512"])
def test_control_fails_the_cells_limits(workload, card):
    """At the cell's own size on the card: the control (the reference in
    fp8 in the program's place) and the fault read in the reference's
    place are rejected by the cell's committed limits."""
    _, cfg, traffic, limits = harness.cell(workload)
    for seed in (2 ** 31 + 11, 2 ** 32 + 3):
        got = calibrate.readings(cfg, traffic, seed, card)
        for what, nums in got.items():
            ok = harness.checks_line(nums, limits)[1]
            assert ok is False, (workload, seed, what, nums)
        torch.cuda.empty_cache()

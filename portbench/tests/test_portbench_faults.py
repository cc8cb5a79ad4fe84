"""A run with the timed path broken underneath comes out not correct:
for each fault the cell can have (a step that leaves its state as it
was; half of each batch, or of each scan's chunks, left out; an answer
altered where it is produced). The chip's look is skipped: the runs
are on the CPU at a size a test holds."""

import pytest

from portbench import run as bench_run

from ._tiny import tiny

CASES = [("train.att.b10", "state_unchanged"),
         ("train.att.b10", "half_batch"),
         ("train.dc3d.b10", "state_unchanged"),
         ("train.dc3d.b10", "half_batch"),
         ("infer.att.mixed512", "alter_answer"),
         ("infer.att.mixed512", "half_batch")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_not_correct(workload, fault):
    res, lines = bench_run.run_cell(workload, 2 ** 31 + 5, 0.5, 0, "cpu",
                                    fault=fault, overrides=tiny(workload))
    assert res["correct"] is False, lines

"""The judge's control and faults on the CPU, on the toy chain cells: the
rest of a run driven with the timed path broken underneath, and `correct`
must come out false, each time through the number that should catch it."""

import pytest

from portbench import control, run

SEED = 2**31 + 811


@pytest.mark.parametrize("workload,plant,catches", [
    # the control: no zero-knowledge draws, so each proof equals the
    # warm-up's proof of its witness
    ("chain.prove1", "zk_off", "blinding"),
    # the control of the service's cell: another trusted setup's keys
    ("chain.tx1", "other_setup", "key"),
    # an answer altered where it is produced
    ("chain.prove1", "altered", "rejected"),
    ("chain.tx1", "altered", "rejected"),
    # half of the batch left out
    ("chain.batch2", "half_batch", "rejected"),
])
def test_planted_fault_is_caught(checkout, workload, plant, catches):
    res = run.run_cell(checkout, workload, SEED, 0.5, False, ["cpu"],
                       plant=control.PLANTS[plant])
    assert res["correct"] is False
    assert res["checks"][catches]["value"] > res["checks"][catches]["limit"]

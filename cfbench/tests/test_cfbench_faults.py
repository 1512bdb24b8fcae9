"""A run with the timed path broken underneath (cfbench/faults.py) comes
out not correct, for each fault a cell can have. The program runs in
float32 at a tiny size, where the reference matches it to rounding and the
unbroken run is correct (test_cfbench_loops.py)."""

import pytest

from cfbench_tiny import CELLS, load, run_tiny
from cfbench import faults

CASES = [(cell, fault) for cell in CELLS
         for fault in faults.FAULTS[load(cell)["loop"]]]


@pytest.mark.parametrize("cell, fault", CASES)
def test_fault_is_caught(cell, fault):
    loop = load(cell)["loop"]
    with faults.planted(fault, loop):
        result = run_tiny(cell, float32=True)
    assert not result["correct"], result["checks"]


def test_half_batch_keeps_whole_microbatches():
    # a batch of 6 in 2 microbatches: half is 3 rows, which 2 does not
    # divide; the fault leaves out 4 and still runs, and is caught
    from cfbench_tiny import harness, tiny

    wl = tiny("middle_train_frozen", float32=True)
    wl["params"]["batch"] = 6
    with faults.planted("half_batch", "train_step"):
        result = harness.run_cell(wl, 2 ** 33 + 17, 2.0, False, device="cpu")
    assert not result["correct"], result["checks"]
    assert result["checks"]["fwd_rms"]["value"] == float("inf")

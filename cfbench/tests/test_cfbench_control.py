"""The control (the reference in fp8 in the program's place) fails each
cell's check: here at a tiny size on the CPU; ``-m cuda``: at the cell's
own size on the card (cfbench/control.py does the same from the command
line)."""

import pytest
import torch

from cfbench_tiny import CELLS, harness, tiny
from cfbench import control


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_check_at_a_tiny_size(name):
    got = control.readings(tiny(name), 5, "cpu")
    assert not got["passes"], got


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  harness.benchmark_spec()["workloads"]])
def test_control_fails_the_check_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = control.readings(harness.load_workload(name), 2 ** 31 + 5, "cuda")
    assert not got["passes"], got

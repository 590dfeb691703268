"""The control (the plain reference in bfloat16 in the program's place)
must fail a cell's check; the program must pass it. On the CPU at small
scenes; with the card (marker ``cuda``) at the cells' own sizes."""

import pytest
import torch

import control
from test_benchmark_faults import CELLS


def _fails(r):
    return any(r["control"][n] > r["limits"][n] for n in r["limits"])


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_fails_and_program_passes_on_cpu(workload):
    torch.set_num_threads(2)
    config, traffic = CELLS[workload]
    r = control.readings(workload, 2**31 + 5, 0.05, True, device="cpu",
                         config=config, traffic=traffic)
    assert all(v <= r["limits"][n] for n, v in r["program"].items()), r
    assert _fails(r), r


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_fails_and_program_passes_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r = control.readings(workload, 2**31 + 7, 0.5, True)
    assert all(v <= r["limits"][n] for n, v in r["program"].items()), r
    assert _fails(r), r

"""A whole run without the card's look (the CPU path of the program, at a
small scene) must come out correct, and with the timed path broken
underneath, not correct: for each fault a cell can have (``faults.py``),
a step that leaves its state unchanged, half of the batch left out, an
answer altered where it is produced."""

import pytest
import torch

import faults
from benchlib import runner

SOFT = {"cameras": "turntable", "level": 1, "views": 4, "image": [32, 32],
        "focal_scale": 0.8, "distance": 3.0, "sigma": 1e-4,
        "displacement": 0.05}
DEPTH = {"cameras": "orbit", "level": 1, "views": 4, "image": [24, 40],
         "focal_scale": 0.9, "distance": 2.7, "elevation": 15.0, "bin": 8,
         "faces_per_pixel": 1, "displacement": 0.05}
CELLS = {
    "softsil-ico3-256x8.fit": (SOFT, {"warmup_steps": 2}),
    "softsil-ico3-256x8.render": (SOFT, {"batch": 2, "pool": 6,
                                         "warmup_steps": 1}),
    "depth-ico3-720p.calls12": (DEPTH, {"views_per_call": 2,
                                        "warmup_steps": 1}),
    "depth-ico3-720p.calls120": (DEPTH, {"views_per_call": 4,
                                         "warmup_steps": 1}),
}


def run(workload, seed=2**31 + 99):
    config, traffic = CELLS[workload]
    out = runner.run_cell(workload, seed, 0.05, False, device="cpu",
                          config=config, traffic=traffic)
    return all(v <= limit for _, v, limit in out["checks"]), out


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct(workload):
    correct, out = run(workload)
    assert correct, out["checks"]
    # a run on the CPU has no set-up clock
    assert out["attempted"] >= 1 and set(out["metrics"]) == {
        m["name"] for m in runner.cell(workload)["end_to_end"]
        if m["name"] != "setup_s"}
    assert runner.jax_modules() == []


FAULTS = [(w, f) for w in sorted(CELLS) for f in faults.NAMES
          if faults.applies(w, f)]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_is_not_correct(workload, fault):
    with faults.plant(workload, fault):
        correct, out = run(workload)
    assert not correct, out["checks"]

"""The readers of the program's spans (``benchlib/spans.py``, the
``glue_ms.<layer>`` metrics): on a reading that already holds its spans
window, on the CPU path of a small cell with the markers the card would
record (recorded instead of launched), and where the program has no
spans, the reading no run or the run no cell (None, never a raise)."""

import pytest
import torch

from benchlib import runner, spans, trace
from test_benchmark_faults import CELLS
from torch_renderer_tpu_torch.utils import timing

LAYERS = ("setup", "binning", "raster", "untile", "outside")
NEW = [f"glue_ms.{layer}.{group}" for group in ("soft", "depth")
       for layer in LAYERS]


def _read(name, reading):
    return runner.load_file(runner.reader_file(name),
                            f"m_{name.replace('.', '_')}").read(reading)


def _reading(steps=range(3, 5), scene=None):
    return runner.Reading({"device": [("k", 0.0, 1.0)], "window_s": 1e-6},
                          steps, [1e-6], set(), lambda i: range(1),
                          scene or {})


@pytest.mark.parametrize("name", NEW)
def test_names_resolve_to_their_own_readers(name):
    quantity = name.rsplit(".", 1)[0]
    assert runner.reader_file(name).name == f"{quantity}.py"
    assert runner.reader_file(name).name != "glue_ms_per_step.py"


def test_readers_read_the_window_kept_on_the_reading():
    r = _reading()
    r.spans = {"layers": {"setup": 0.01, "binning": 0.02, "raster": 0.03,
                          "untile": 0.04, "outside": 0.05}}
    for group in ("soft", "depth"):
        assert [_read(f"glue_ms.{layer}.{group}", r) for layer in LAYERS] \
            == [0.01, 0.02, 0.03, 0.04, 0.05]


def test_nothing_to_read_outside_a_run_or_without_spans(monkeypatch):
    # no run_cell frame: nothing to rebuild
    assert all(_read(name, _reading()) is None for name in NEW)
    # a program without spans (the parent of the spans): nothing to read
    monkeypatch.setattr(spans, "_timing", lambda: None)
    r = _reading()
    assert _read("glue_ms.raster.soft", r) is None and r.spans is None


def test_nothing_to_read_where_the_run_names_its_locals_otherwise(
        monkeypatch):
    """A run_cell whose cell is not under the name ``c`` (a later runner)
    costs these metrics, not the run."""
    scene = {"verts": torch.zeros((3, 3))}

    def run_cell():
        cell = runner.cell("softsil-ico3-256x8.fit")  # noqa: F841
        return {name: _read(name, _reading(scene=scene)) for name in NEW}

    monkeypatch.setattr(runner, "run_cell", run_cell)
    assert all(v is None for v in run_cell().values())


@pytest.fixture
def cpu_card(monkeypatch):
    """The CPU path with the markers a card would launch recorded on a
    synthetic device clock: each marker, then 1 µs of glue, in launch
    order; trace.profile runs the steps and returns them with the host's
    ``trt/`` records."""
    clock, device = [0.0], []

    def mark(sid, opening, index):
        t = clock[0]
        device.append((f"void {timing.MARKER}<{sid}, {int(opening)}>()", t,
                       t + 1.0))
        device.append(("elementwise_kernel", t + 1.0, t + 2.0))
        clock[0] += 3.0

    def profile(loop, first, steps):
        from torch.profiler import ProfilerActivity, profile as prof_cpu

        device.clear()
        with prof_cpu(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(first, first + steps):
                loop.step(i)
        cpu = [(e.name, e.time_range.start, e.time_range.end)
               for e in prof.events()]
        return {"device": list(device), "cpu": cpu, "window_s": clock[0],
                "marks": 1, "attempts": 1, "next": first + steps}

    monkeypatch.setattr(timing, "_cuda_index", lambda on: 0)
    monkeypatch.setattr(timing, "_mark", mark)
    monkeypatch.setattr(trace, "profile", profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(spans, "_Ahead", lambda loop, ahead: loop)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_spans_window_of_a_small_cell(workload, cpu_card, monkeypatch,
                                      capsys):
    """A reader inside a run (a stand-in for run_cell with the cell as its
    local ``c`` and the scene on the reading) rebuilds the loop with spans
    on and splits its steps: every layer the cell runs reads glue, the
    layers add up to the window's glue, and spans are off after."""
    config, traffic = CELLS[workload]
    group = "soft" if workload.startswith("softsil") else "depth"

    def run_cell():
        c, scene, loop = runner.prepare(workload, 7, torch.device("cpu"),
                                        config, traffic)
        loop.release()
        r = _reading(range(2, 4), scene)
        return r, {name: _read(name, r) for name in NEW
                   if name.endswith(group)}

    monkeypatch.setattr(runner, "run_cell", run_cell)
    r, got = run_cell()
    assert not timing.spans_enabled()
    split = r.spans
    assert split is not None and split["markers"] > 0
    for layer in LAYERS:
        assert got[f"glue_ms.{layer}.{group}"] == split["layers"][layer]
    assert sum(split["layers"].values()) == pytest.approx(split["glue_ms"])
    assert split["glue_ms"] == pytest.approx(split["ops"] * 1e-3)
    used = ("setup", "binning", "raster", "untile")
    assert all(split["layers"][layer] > 0 for layer in used)
    if workload.endswith(".fit"):
        assert {"setup.bwd", "raster.bwd", "untile.bwd"} <= set(
            split["spans"])
    line = [x for x in capsys.readouterr().err.splitlines()
            if x.startswith("spans: ")]
    assert len(line) == 1 and '"captures": 0' in line[0]

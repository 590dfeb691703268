"""BENCHMARK.json against the benchmark's contract, and every cell's
configuration, traffic mix, loop, metric and work files found by name."""

import importlib
import json
import re
from pathlib import Path

import pytest

from benchlib import runner

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"][:2] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    # a full check of the full 24 cells: 2 + 14 runs a cell, each
    # run_seconds + 60 s, 180 s a cell to compile, 1200 s spare
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len(json.dumps(MAN)) < 64 * 1024


def test_names_and_units():
    names = ([c["name"] for c in MAN["configs"]] + CELLS
             + [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    # the issue's three quantities, images_per_s and step_ms_p95 split by
    # the cells that report them so that each group has its own bound
    assert {m["name"].split(".")[0] for m in MAN["end_to_end"]} == {
        "images_per_s", "step_ms_p95", "setup_s"}
    reports = {w: {m["name"] for m in MAN["end_to_end"]
                   if w in m.get("workloads", CELLS)} for w in CELLS}
    for w in CELLS:
        assert "setup_s" in reports[w] and len(reports[w]) >= 2
        assert any(w in m["workloads"] for m in MAN["per_layer"])
    for m in MAN["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"].startswith("images_per_s")
        assert set(m["workloads"]) <= set(CELLS)
        for w in m["workloads"]:
            assert m["moves"] in reports[w], (m["name"], w)
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert 1 <= len(c["source"]) <= 200
        # every key changed from the source is in the file, listed alike
        # there, and said why among the file's assumptions
        config = json.loads((ROOT / c["file"]).read_text())
        assert c["reduced"] == config["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in config
            assert any(a.startswith(key + ":") for a in config["assumed"])


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_by_name(workload):
    c = runner.cell(workload)
    assert hasattr(c["loop"], "Loop") and hasattr(c["loop"], "check")
    assert hasattr(c["loop"], "control")
    assert c["per_layer"], "every cell reports a per-layer metric"
    ref = ROOT / c["config"]["reference"].replace("reference/",
                                                  "benchmark/reference/")
    assert ref.is_file()
    for m in c["per_layer"]:
        reader = runner.load_file(runner.reader_file(m["name"]), "m")
        assert callable(reader.read)


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]
                                    if m["name"].startswith("roofline_pct.")])
def test_roofline_work_file_exists(metric):
    op = metric.split(".", 1)[1]
    assert callable(importlib.import_module(f"work.{op}").per_view)


def test_every_config_used():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))

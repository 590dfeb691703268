"""chip_smoke.same_kernels, phase H's gate that a captured run put the eager
run's kernels on the device, on made-up profiler windows: the gate's logic
needs no card. A window that falls short of its run's launches is profiled
again, up to PROFILE_WINDOWS windows a form, before the two forms are
compared; one that falls short every time fails the gate; one within the
gate's allowance (max(2, 1%) events of a name) is not profiled again."""

import collections
import importlib.util
import pathlib

import pytest

EXPECT = {"topk_select": 20}


@pytest.fixture(scope="module")
def chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _window(chip_smoke, ours: int, other: int) -> dict:
    """A kernel_counts record: `ours` topk_select kernels, `other` kernels
    of another name and one copy (left out of the comparison)."""
    counts = {k: 0 for k in chip_smoke.DEVICE_NAMES}
    counts["topk_select"] = ours
    return {"all": collections.Counter({"topk_select_kernel": ours,
                                        "vectorized_elementwise": other,
                                        "Memcpy DtoD": 1}),
            "ours": counts}


def _fake_profiles(chip_smoke, monkeypatch, eager: list, captured: list):
    """Replace kernel_counts by one that runs the form and hands out that
    form's next window; returns run(captured) and the runs of each form."""
    queues = {False: list(eager), True: list(captured)}
    runs = {False: 0, True: 0}

    def run(form):
        runs[form] += 1
        return form

    def kernel_counts(fn):
        return queues[fn()].pop(0)

    monkeypatch.setattr(chip_smoke, "kernel_counts", kernel_counts)
    return run, runs


@pytest.mark.parametrize("short", [(18, 1000), (20, 900)],
                         ids=["ours", "others"])
def test_same_kernels_profiles_a_short_window_again(chip_smoke, monkeypatch,
                                                    short):
    full = _window(chip_smoke, 20, 1000)
    run, runs = _fake_profiles(chip_smoke, monkeypatch,
                               [_window(chip_smoke, *short), full], [full])
    rec = chip_smoke.same_kernels("fake", run, EXPECT)
    assert runs == {False: 2, True: 1}
    assert [w["form"] for w in rec["short_windows"]] == ["eager"]
    assert rec["ours"]["topk_select"] == 20


def test_same_kernels_fails_a_window_short_every_time(chip_smoke,
                                                      monkeypatch):
    n = chip_smoke.PROFILE_WINDOWS
    run, runs = _fake_profiles(
        chip_smoke, monkeypatch, [_window(chip_smoke, 20, 1000)],
        [_window(chip_smoke, 17, 1000) for _ in range(n)])
    with pytest.raises(AssertionError, match="not the eager run's"):
        chip_smoke.same_kernels("fake", run, EXPECT)
    assert runs == {False: 1, True: n}


def test_same_kernels_takes_a_window_within_its_allowance(chip_smoke,
                                                          monkeypatch):
    run, runs = _fake_profiles(chip_smoke, monkeypatch,
                               [_window(chip_smoke, 20, 1000)],
                               [_window(chip_smoke, 20, 991)])
    rec = chip_smoke.same_kernels("fake", run, EXPECT)
    assert runs == {False: 1, True: 1} and rec["short_windows"] == []
    assert rec["count_diff"] == {"vectorized_elementwise": (1000, 991)}

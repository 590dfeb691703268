"""chip_smoke.same_kernels, phase H's gate that a captured run put the eager
run's kernels on the device, on made-up profiler windows: the gate's logic
needs no card. A window that falls short of its run's launches, or of the
other form's window in one name beyond the gate's allowance, is profiled
again, up to PROFILE_WINDOWS windows a form, before the two forms are
compared; one that falls short every time fails the gate; one within the
gate's allowance (max(2, 1%) events of a name) is not profiled again, nor
one that kept some of its opening markers; one that kept none is; the
int64 fills a graph with a registered generator adds (the prologue) are
counted against its captures and replays, a window short of them is
profiled again, and rng_prologue, which measures them, takes the most
fills of its repeated windows."""

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


def _window(chip_smoke, ours: int, other: int, marks: int = 64) -> dict:
    """A kernel_counts record: `ours` topk_select kernels, `other` kernels
    of another name and one copy (left out of the comparison), `marks` of
    the window's opening markers recorded."""
    counts = {k: 0 for k in chip_smoke.DEVICE_NAMES}
    counts["topk_select"] = ours
    return {"all": collections.Counter({"topk_select_kernel": ours,
                                        "vectorized_elementwise": other,
                                        "Memcpy DtoD": 1}),
            "ours": counts, "marks": marks}


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


@pytest.mark.parametrize("short", [(18, 1000), (20, 900), (20, 1000, 0)],
                         ids=["ours", "others", "no markers"])
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


def _named(chip_smoke, counts: dict) -> dict:
    ours = {k: 0 for k in chip_smoke.DEVICE_NAMES}
    ours["topk_select"] = counts.get("topk_select_kernel", 0)
    return {"all": collections.Counter(counts), "ours": ours}


def test_same_kernels_profiles_a_window_short_in_one_name_again(
        chip_smoke, monkeypatch):
    """Equal totals within the allowance, but one name 6 events short of
    115 in the eager window (a profiler drop): profiled again, then
    compared; the same shortfall in every window fails the gate."""
    full = {"topk_select_kernel": 20, "scatter": 115, "other": 2000}
    short = {**full, "scatter": 109}
    run, runs = _fake_profiles(
        chip_smoke, monkeypatch,
        [_named(chip_smoke, short), _named(chip_smoke, full)],
        [_named(chip_smoke, full)])
    rec = chip_smoke.same_kernels("fake", run, EXPECT)
    assert runs == {False: 2, True: 1} and rec["count_diff"] == {}
    n = chip_smoke.PROFILE_WINDOWS
    run, runs = _fake_profiles(
        chip_smoke, monkeypatch, [_named(chip_smoke, short)] * n,
        [_named(chip_smoke, full)])
    with pytest.raises(AssertionError, match="not the eager run's"):
        chip_smoke.same_kernels("fake", run, EXPECT)
    assert runs == {False: n, True: 1}


PROLOGUE = {"name": "FillFunctor<long>", "per_capture": 4, "per_replay": 2}
FILL = "vectorized_elementwise_kernel<2, FillFunctor<long>"


@pytest.mark.parametrize("extra,ok", [(0, True), (2, True), (4, False),
                                      (-4, False)],
                         ids=["exact", "allowance", "extra", "missing"])
def test_same_kernels_counts_the_replay_prologue(chip_smoke, monkeypatch,
                                                 extra, ok):
    """A captured window of one capture and 20 replays of a graph that
    draws from a registered generator: its int64 fills must be the eager
    window's plus 4 for the capture and 2 a replay (45), within the
    allowance (max(2, 1%)); a fill more or less inside the step beyond it
    fails the gate."""
    eager = _named(chip_smoke, {"topk_select_kernel": 20, "other": 1000,
                                FILL: 1})
    eager["graphs"] = {"captures": 0, "replays": 0}
    captured = _named(chip_smoke, {"topk_select_kernel": 20, "other": 1000,
                                   FILL: 45 + extra})
    captured["graphs"] = {"captures": 1, "replays": 20}
    run, runs = _fake_profiles(chip_smoke, monkeypatch,
                               [eager] * 3, [captured] * 3)
    if ok:
        rec = chip_smoke.same_kernels("fake", run, EXPECT, PROLOGUE)
        assert rec["count_diff"] == {}
        assert rec["prologue"]["want"] == 45
        assert rec["prologue"]["captured"] == 45 + extra
    else:
        with pytest.raises(AssertionError, match="not the eager run's"):
            chip_smoke.same_kernels("fake", run, EXPECT, PROLOGUE)
    # without the prologue the fills are compared as any other name
    run, runs = _fake_profiles(chip_smoke, monkeypatch,
                               [eager] * 3, [captured] * 3)
    with pytest.raises(AssertionError, match="not the eager run's"):
        chip_smoke.same_kernels("fake", run, EXPECT)


def test_same_kernels_profiles_a_window_short_in_its_prologue_again(
        chip_smoke, monkeypatch):
    """A captured window that dropped 6 of its 45 int64 fills (a profiler
    drop, as a window of 5 replays did on the card) is profiled again;
    the full one then meets the gate."""
    eager = _named(chip_smoke, {"topk_select_kernel": 20, "other": 1000,
                                FILL: 1})
    eager["graphs"] = {"captures": 0, "replays": 0}
    windows = []
    for fills in (39, 45):
        w = _named(chip_smoke, {"topk_select_kernel": 20, "other": 1000,
                                FILL: fills})
        w["graphs"] = {"captures": 1, "replays": 20}
        windows.append(w)
    run, runs = _fake_profiles(chip_smoke, monkeypatch, [eager], windows)
    rec = chip_smoke.same_kernels("fake", run, EXPECT, PROLOGUE)
    assert runs == {False: 1, True: 2}
    assert [w["form"] for w in rec["short_windows"]] == ["captured"]
    assert rec["prologue"]["captured"] == rec["prologue"]["want"] == 45


@pytest.mark.parametrize("fills,ok", [
    ([6, 6, 6, 14, 14, 14], True),
    ([6, 5, 6, 8, 14, 12], True),
    ([6, 6, 6, 8, 8, 8], False)], ids=["full", "drops", "short every time"])
def test_rng_prologue_takes_the_most_fills_of_its_windows(
        chip_smoke, monkeypatch, fills, ok):
    """rng_prologue profiles a graph's capture and 1 replay, and a new
    graph's capture and 5 replays, PROFILE_WINDOWS times each; the most
    fills of each stand for it (4 a capture, 2 a replay), so a window that
    dropped some does not change the count; a shortfall in every window
    of one kind fails."""
    import torch_renderer_tpu_torch.utils.graph as graph

    class FakeGraph:
        def __init__(self, step, device, capture, generators):
            self.step = step

        def __call__(self):
            return self.step()

        def release(self):
            pass

    queue = list(fills)
    assert len(queue) == 2 * chip_smoke.PROFILE_WINDOWS

    def kernel_counts(fn):
        fn()
        n = 1 if len(queue) > chip_smoke.PROFILE_WINDOWS else 5
        return {"all": collections.Counter({FILL: queue.pop(0)}),
                "marks": 64, "graphs": {"captures": 1, "replays": n}}

    monkeypatch.setattr(graph, "StepGraph", FakeGraph)
    monkeypatch.setattr(chip_smoke, "kernel_counts", kernel_counts)
    if ok:
        rec = chip_smoke.rng_prologue("cpu", "fake card")
        assert (rec["per_capture"], rec["per_replay"]) == (4, 2)
        assert rec["fills"] == [6, 14]
    else:
        with pytest.raises(AssertionError, match="not a fixed count"):
            chip_smoke.rng_prologue("cpu", "fake card")

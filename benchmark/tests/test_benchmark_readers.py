"""The per-layer readers and the trace helpers on a synthetic traced
window (the card's profiler runs only on the card)."""

import pytest

from benchlib import peaks, runner, scene as scenes, trace
from test_benchmark_work import SOFT
from work import soft_coverage_fwd

def test_own_kernels_are_read_from_the_sources():
    own = trace.own_kernel_names()
    for name in ("soft_coverage_fwd_kernel", "soft_coverage_bwd_kernel",
                 "hard_k1_kernel", "untile_kernel", "gather_fwd_kernel",
                 "gather_bwd_kernel", "topk_select_kernel",
                 "points_select_kernel", "texsample_fwd_kernel",
                 "svd3_kernel"):
        assert name in own
    assert trace.has_name("void hard_k1_kernel<false>(float const*)",
                          "hard_k1_kernel")
    assert not trace.has_name("xhard_k1_kernel(int)", "hard_k1_kernel")
    assert not trace.has_name("hard_k1_kernel_v2(int)", "hard_k1_kernel")


@pytest.fixture
def reading():
    scene = scenes.make_scene(SOFT, 17, 3, "cpu")
    fwd = "soft_coverage_fwd_kernel(float const*, int const*)"
    glue = "at::native::vectorized_elementwise_kernel<4, FillFunctor<float>>"
    device = [(fwd, 0.0, 10.0), (glue, 12.0, 15.0), (fwd, 40.0, 50.0),
              (glue, 50.0, 52.0)]
    traced = {"device": device, "window_s": 100e-6}
    return runner.Reading(traced, range(5, 7), [10e-6, 30e-6],
                          trace.own_kernel_names(), lambda i: range(3),
                          scene), scene


def _read(name, r):
    return runner.load_file(runner.HERE / "metrics" / f"{name}.py",
                            "m").read(r)


def test_readers_on_a_synthetic_window(reading):
    r, scene = reading
    assert r.busy_s == pytest.approx(25e-6)
    assert _read("device_idle_pct", r) == pytest.approx(75.0)
    assert _read("kernels_per_step", r) == 2.0
    assert _read("glue_ms_per_step", r) == pytest.approx(2.5e-3)
    assert _read("host_us_per_step", r) == pytest.approx(20.0)
    ops, nbytes = soft_coverage_fwd.per_view(scene)
    least = peaks.bound_s(float(ops.sum()), float(nbytes.sum()))
    assert _read("roofline_pct.soft_coverage_fwd", r) == pytest.approx(
        100.0 * 2 * least / 20e-6)
    # a kernel that did not run: nothing to read, never 0
    assert _read("roofline_pct.soft_coverage_bwd", r) is None
    assert _read("roofline_pct.untile", r) is None


def test_breakdown_names_gaps_by_the_host_op():
    device = [("a(int)", 0.0, 10.0), ("b(int)", 30.0, 35.0),
              ("a(int)", 36.0, 40.0)]
    cpu = [("cudaGraphLaunch", 5.0, 25.0), ("outer", 0.0, 50.0)]
    out = trace.breakdown(device, cpu)
    assert out["device_ops"][0] == ["a", pytest.approx(14e-6)]
    assert out["idle_gaps"][0] == ["cudaGraphLaunch", pytest.approx(20e-6)]
    assert out["idle_gaps"][1] == ["outer", pytest.approx(1e-6)]
    assert len(out["device_ops"]) <= 10 and len(out["idle_gaps"]) <= 10


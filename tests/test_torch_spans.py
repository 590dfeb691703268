"""The program's spans and counters (utils/timing.py).

On the CPU: with spans off no marker is launched, no autograd node and no
profiler record is added, and the soft silhouette (with its gradient) and
the depth render are bit for bit what they are with spans on; with spans
on the host spans nest under their parents, the backward opens and closes
the ``.bwd`` spans, and the device markers the render path would launch
(recorded instead of launched) pair up and nest. The benchmark's reader
of a profiled window (``benchmark/benchlib/spans.py`` ``split``) on
synthetic device lists: self time, "outside", markers that do not pair up
or do not repeat each step (None), and idle gaps named by span.

Marked ``cuda`` (skip without a card): a StepGraph captured with spans on
records one whole set of markers on every replay; its outputs are bitwise
those of the graph captured with spans off (the gradient within 1e-6 of
its largest: the tile gather's backward adds with float32 atomics, whose
order changes from run to run with spans off too); and the spans-off
graph launches exactly the kernels of the spans-on graph less its
markers.
"""

import collections
import sys
from pathlib import Path

import pytest
import torch

from torch_renderer_tpu_torch.apps._common import pinhole_K
from torch_renderer_tpu_torch.cameras.look_at import look_at_view_transform
from torch_renderer_tpu_torch.cameras.perspective import PerspectiveCamera
from torch_renderer_tpu_torch.ops.icosphere import icosphere
from torch_renderer_tpu_torch.rasterize import cuda_soft
from torch_renderer_tpu_torch.rasterize.geometry import setup_face_planes
from torch_renderer_tpu_torch.renderer import DepthRender
from torch_renderer_tpu_torch.structures.meshes import Meshes
from torch_renderer_tpu_torch.utils import timing
from torch_renderer_tpu_torch.utils.graph import StepGraph

_BENCHMARK = str(Path(__file__).resolve().parents[1] / "benchmark")
if _BENCHMARK not in sys.path:
    sys.path.insert(0, _BENCHMARK)
from benchlib import spans as bench_spans  # noqa: E402

SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _spans_off():
    before = timing.enable_spans(False)
    yield
    timing.enable_spans(before)


def _scene(device="cpu"):
    v, f = icosphere(1)
    meshes = Meshes.from_single(v, f, device=device).extend(2)
    R, t = look_at_view_transform(2.7, 15.0, torch.tensor([0.0, 90.0]))
    cam = PerspectiveCamera.from_K(pinhole_K((SIZE, SIZE)), (SIZE, SIZE),
                                   R=R, t=t, device=device)
    return meshes, cam, R.to(device), t.to(device)


def _soft(meshes, cam):
    """The fit's inner step: alpha and d sum(alpha) / d verts."""
    v = meshes.verts.detach().clone().requires_grad_(True)
    fp = setup_face_planes(meshes.update_padded(v), cam)
    alpha = cuda_soft.soft_silhouette_fd(fp, (SIZE, SIZE), sigma=1e-4,
                                         faces_per_tile=64)
    (g,) = torch.autograd.grad(alpha.sum(), v)
    return alpha, g


def _renderer(device="cpu"):
    return DepthRender(pinhole_K((SIZE, SIZE)), (SIZE, SIZE), bin_size=8,
                       max_faces_per_bin=64, device=device)


def _depth(meshes, R, t, renderer=None):
    renderer = renderer or _renderer(meshes.verts.device)
    with torch.no_grad():
        return renderer.render(meshes, R, t)


def _graph_nodes(t: torch.Tensor) -> collections.Counter:
    """The autograd graph behind t, by node type."""
    seen, todo, kinds = set(), [t.grad_fn], collections.Counter()
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        kinds[type(node).__name__] += 1
        todo.extend(n for n, _ in node.next_functions)
    return kinds


def _host_spans(fn):
    """fn() under the profiler: (its result, [(name, start, end)] of the
    ``trt/`` host records)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [(e.name[len(timing.HOST_PREFIX):], e.time_range.start,
                  e.time_range.end) for e in prof.events()
                 if e.name.startswith(timing.HOST_PREFIX)]


def _parent(spans, child) -> str | None:
    """The innermost span around child (name, start, end)."""
    around = [(b - a, n) for n, a, b in spans
              if (n, a, b) != child and a <= child[1] and child[2] <= b]
    return min(around)[1] if around else None


def test_spans_off_add_nothing(monkeypatch):
    marks = []
    monkeypatch.setattr(timing, "_mark", lambda *a: marks.append(a))
    meshes, cam, R, t = _scene()
    (alpha, g), records = _host_spans(lambda: _soft(meshes, cam))
    depth, more = _host_spans(lambda: _depth(meshes, R, t))
    assert marks == [] and records == [] and more == []
    v = meshes.verts.detach().clone().requires_grad_(True)
    fp = setup_face_planes(meshes.update_padded(v), cam)
    alpha_off = cuda_soft.soft_silhouette_fd(fp, (SIZE, SIZE), sigma=1e-4,
                                             faces_per_tile=64)
    nodes_off = _graph_nodes(alpha_off)
    assert not {"_BackwardOpensBackward", "_BackwardClosesBackward"} \
        & set(nodes_off)
    timing.enable_spans(True)
    alpha_on, g_on = _soft(meshes, cam)
    depth_on = _depth(meshes, R, t)
    timing.enable_spans(False)
    assert torch.equal(alpha, alpha_on) and torch.equal(g, g_on)
    assert torch.equal(depth, depth_on)


def test_spans_on_nest_on_the_host():
    meshes, cam, R, t = _scene()

    def step():
        return _soft(meshes, cam), _depth(meshes, R, t)

    timing.enable_spans(True)
    graph = StepGraph(step, "cpu")
    ((alpha, g), depth), spans = _host_spans(graph)
    timing.enable_spans(False)
    (alpha0, g0), depth0 = step()
    assert torch.equal(alpha, alpha0) and torch.equal(g, g0)
    assert torch.equal(depth, depth0)

    parents = collections.defaultdict(set)
    for s in spans:
        parents[s[0]].add(_parent(spans, s))
    assert parents["issue"] == {None}
    assert parents["step"] == {"issue"}
    # the soft silhouette's layers, its backward's, and the depth
    # render's: every layer directly under the step, binning's slot
    # assignment also inside the candidate gather
    assert parents["setup"] == {"step"}
    assert parents["binning"] == {"step", "raster"}
    assert parents["raster"] == {"step"}
    assert parents["untile"] == {"step"}
    for bwd in ("setup.bwd", "raster.bwd", "untile.bwd"):
        assert parents[bwd] == {"step"}, bwd
    order = [n for n, _, _ in sorted(spans, key=lambda s: s[1])
             if n.endswith(".bwd")]
    assert order == ["untile.bwd", "raster.bwd", "setup.bwd"]


def test_device_markers_pair_up(monkeypatch):
    """The markers a card would record, in launch order, from the CPU path
    with a device index forced: read back by the benchmark's split, they
    pair up and
    put the step's work in the layers."""
    marks = []
    monkeypatch.setattr(timing, "_cuda_index", lambda on: 0)
    monkeypatch.setattr(timing, "_mark",
                        lambda sid, opening, index: marks.append(
                            (sid, opening)))
    meshes, cam, R, t = _scene()
    timing.enable_spans(True)
    StepGraph(lambda: (_soft(meshes, cam), _depth(meshes, R, t)), "cpu")()
    timing.enable_spans(False)
    names = [(timing.DEVICE_SPANS[sid], o) for sid, o in marks]
    assert names[0] == ("step", True) and names[-1] == ("step", False)
    assert {n for n, _ in names} == set(timing.DEVICE_SPANS)
    device = []
    for i, (sid, opening) in enumerate(marks):
        device.append((f"void {timing.MARKER}<(int){sid}, (int)"
                       f"{int(opening)}>()", 10 * i, 10 * i + 1))
        device.append(("elementwise_kernel", 10 * i + 2, 10 * i + 5))
    split = _split(device, [], 1, lambda n: False)
    assert split is not None
    assert split["markers"] == len(marks)
    assert set(split["spans"]) == set(timing.DEVICE_SPANS) | {"outside"}
    # each kernel counts to the span open after the marker before it
    opened, want = [], collections.Counter()
    for name, opening in names:
        if opening:
            opened.append(name)
        else:
            opened.reverse()
            opened.remove(name)
            opened.reverse()
        want[bench_spans.layer_of(opened[-1] if opened else None)] += 0.003
    assert split["layers"] == pytest.approx(
        {k: want[k] for k in bench_spans.LAYERS + ("outside",)})


def _split(device, cpu, steps, is_own, top=10):
    return bench_spans.split(device, cpu, steps, is_own, timing.DEVICE_SPANS,
                             top)


def _mark(span_name, opening):
    sid = timing.SPAN_IDS[span_name]
    return f"void {timing.MARKER}<{sid}, {int(opening)}>()"


def _window(steps=2):
    """A synthetic device list of ``steps`` steps (µs): step [ setup [k]
    raster [ binning [k] k own ] ] then a copy outside any span, each step
    100 µs long."""
    ev = []
    for s in range(steps):
        o = 100 * s
        ev += [(_mark("step", True), o, o + 1),
               (_mark("setup", True), o + 2, o + 3),
               ("elementwise_kernel", o + 4, o + 14),
               (_mark("setup", False), o + 15, o + 16),
               (_mark("raster", True), o + 17, o + 18),
               (_mark("binning", True), o + 19, o + 20),
               ("tensor_kernel_scan_innermost_dim", o + 21, o + 41),
               (_mark("binning", False), o + 42, o + 43),
               ("gather_kernel", o + 44, o + 49),
               ("soft_fwd_kernel", o + 50, o + 70),
               (_mark("raster", False), o + 71, o + 72),
               (_mark("step", False), o + 73, o + 74),
               ("Memcpy DtoD", o + 90, o + 96),
               ("trt/issue", o, o + 80)]
    return ev


def _own(name):
    return "soft_fwd_kernel" in name or timing.MARKER in name


def test_span_split_self_time_and_outside():
    cpu = [("trt/issue", 0, 80), ("trt/issue/replay", 5, 75),
           ("trt/issue", 100, 180)]
    split = _split(_window(), cpu, 2, _own)
    spans = split["spans"]
    assert spans["setup"] == {"device_ms": 0.010, "glue_ms": 0.010,
                              "ops": 1}
    # binning's scan is binning's own, not raster's
    assert spans["binning"]["glue_ms"] == pytest.approx(0.020)
    assert spans["raster"]["glue_ms"] == pytest.approx(0.005)
    assert spans["raster"]["device_ms"] == pytest.approx(0.025)
    assert spans["outside"]["glue_ms"] == pytest.approx(0.006)
    assert split["layers"] == pytest.approx(
        {"setup": 0.010, "binning": 0.020, "raster": 0.005, "untile": 0.0,
         "outside": 0.006})
    assert split["glue_ms"] == pytest.approx(0.041)
    assert split["ops"] == 5 and split["markers"] == 8
    assert split["busy_ms"] == pytest.approx(0.069)


@pytest.mark.parametrize("fault", ["unclosed", "closes_unopened",
                                   "one_step_short", "no_markers"])
def test_span_split_refuses_a_window_it_cannot_split(fault):
    ev = _window()
    if fault == "unclosed":
        ev = [e for e in ev if e[0] != _mark("raster", False) or e[1] < 100]
    elif fault == "closes_unopened":
        ev = [e for e in ev if e[0] != _mark("setup", True) or e[1] > 100]
    elif fault == "one_step_short":
        ev = [e for e in ev if e[1] < 100
              or e[0] not in (_mark("setup", True), _mark("setup", False))]
    else:
        ev = [e for e in ev if timing.MARKER not in e[0]]
    assert _split(ev, [], 2, _own) is None


def test_span_split_names_idle_gaps():
    cpu = [("trt/issue", 0, 80), ("trt/issue/replay", 5, 75),
           ("trt/issue", 100, 185), ("trt/issue/key", 181, 184),
           ("aten::copy_", 80, 95)]
    gaps = _split(_window(), cpu, 2, _own, top=3)["idle_gaps"]
    # the longest gaps: between the step's close and the copy (16 µs; the
    # host in no span at the first step's, in "issue/key" at the
    # second's), then from the copy to the next step (4 µs)
    assert gaps[0] == [None, None, pytest.approx(0.016)]
    assert gaps[1] == [None, "issue/key", pytest.approx(0.016)]
    assert gaps[2] == [None, None, pytest.approx(0.004)]
    inside = _split(
        [(_mark("step", True), 0, 1), ("k", 1, 2), ("k", 30, 31),
         (_mark("step", False), 31, 32)],
        [("trt/issue/replay", 0, 5)], 1, _own)["idle_gaps"]
    assert inside == [["step", None, pytest.approx(0.028)]]


@pytest.mark.parametrize("name,want", [
    ("void trt_span_marker<3, 1>()", ("binning", True)),
    ("void (anonymous namespace)::trt_span_marker<(int)5, (int)0>()",
     ("raster.bwd", False)),
    ("void other_kernel<3, 1>()", None),
])
def test_marker_names(name, want):
    assert bench_spans.marker(name, timing.DEVICE_SPANS) == want


def test_counters_count_and_reset():
    before = timing.counters()
    timing.count("test.events")
    timing.count("test.events", 2)
    assert timing.counters()["test.events"] - before["test.events"] == 3
    assert timing.counters()["test.never"] == 0


def test_only_device_spans_launch_markers(monkeypatch):
    """The issuing call's spans are host records only, whatever device
    they are given; a device span marks its device at entry and exit, and
    not at all on the CPU."""
    marks = []
    monkeypatch.setattr(timing, "_mark", lambda *a: marks.append(a))
    timing.enable_spans(True)
    for name in ("issue", "issue/key", "issue/copy_in", "issue/replay"):
        with timing.span(name, torch.device("cuda", 0)):
            pass
    with timing.span("setup", torch.device("cpu")):
        pass
    assert marks == []
    with timing.span("setup", torch.device("cuda", 1)):
        pass
    timing.enable_spans(False)
    assert marks == [(timing.SPAN_IDS["setup"], True, 1),
                     (timing.SPAN_IDS["setup"], False, 1)]


def test_profiler_trace_turns_spans_on(tmp_path):
    meshes, cam, _, _ = _scene()
    with timing.profiler_trace(str(tmp_path)):
        assert timing.spans_enabled()
        _soft(meshes, cam)
    assert not timing.spans_enabled()
    text = (tmp_path / "trace.json").read_text()
    assert '"trt/raster.bwd"' in text and '"trt/setup"' in text


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _captured(device, spans: bool):
    """A captured StepGraph of the soft fit step and a depth render, its
    graph captured with spans on or off."""
    meshes, cam, R, t = _scene(device)
    renderer = _renderer(device)
    before = timing.enable_spans(spans)
    try:
        graph = StepGraph(lambda: (_soft(meshes, cam),
                                   _depth(meshes, R, t, renderer)), device)
        graph()            # the warm-up
        graph()            # the capture and first replay
    finally:
        timing.enable_spans(before)
    return graph


def _replays(graph, n):
    """The device records of n replays. A profiler window can lose the
    records of its first kernels, so it opens with 256 int16 fills and a
    synchronize (left out of the records), as the benchmark's windows do
    (benchmark/benchlib/trace.py)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    marks = torch.empty(256, dtype=torch.int16, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(len(marks)):
            marks[i].fill_(1)
        torch.cuda.synchronize()
        for _ in range(n):
            graph()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA
            and "FillFunctor<short>" not in e.name
            and not e.name.startswith(timing.HOST_PREFIX)
            and not e.name.startswith(("ProfilerStep", "Optimizer."))]


@pytest.mark.cuda
def test_captured_spans_record_on_every_replay(device):
    graph = _captured(device, spans=True)
    one = sum(timing.MARKER in n for n, _, _ in _replays(graph, 1))
    assert one > 0
    ev = _replays(graph, 5)
    assert sum(timing.MARKER in n for n, _, _ in ev) == 5 * one
    split = _split(ev, [], 5, lambda n: timing.MARKER in n)
    assert split is not None and split["markers"] == one
    assert {"setup", "binning", "raster", "untile", "setup.bwd",
            "raster.bwd", "untile.bwd"} <= set(split["spans"])


@pytest.mark.cuda
def test_captured_spans_change_no_output_and_no_kernel(device):
    on, off = _captured(device, True), _captured(device, False)
    (a_on, g_on), d_on = on()
    (a_off, g_off), d_off = off()
    torch.cuda.synchronize()
    assert torch.equal(a_on, a_off) and torch.equal(d_on, d_off)
    # the gather's backward adds with float32 atomics: run to run, the
    # gradient is equal only where the order of a row's terms is
    torch.testing.assert_close(g_on, g_off, rtol=0, atol=1e-6 * float(
        g_off.abs().max()))
    kernels_off = [n for n, _, _ in _replays(off, 1)]
    kernels_on = [n for n, _, _ in _replays(on, 1)
                  if timing.MARKER not in n]
    assert not any(timing.MARKER in n for n in kernels_off)
    assert collections.Counter(kernels_off) == collections.Counter(kernels_on)

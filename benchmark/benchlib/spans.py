"""The spans window of a traced run: the program's layer spans
(``torch_renderer_tpu_torch.utils.timing.span``) read on the profiler's
clock, for the ``glue_ms.<layer>`` readers.

The traced window the harness profiles runs with spans off, as the
measured window does. The first of these readers to run in a traced run
turns spans on, builds the cell's loop again from the same scene (so its
graphs are captured with their span markers), warms it up as the run
did, profiles the same steps as the traced window with ``trace.profile``
(its opening markers and re-profiling unchanged) with at most the
traffic's ``ahead`` steps dispatched ahead of the device, as the
measured window issues them, turns spans off and releases the loop.
``split`` puts each device operation in the innermost span open when it
starts, and gives None where the markers do not pair up or do not repeat
each step: a reader then reads nothing rather than misattribute. The
window is kept on the reading (``reading.spans``) for the readers after
it, and its summary is printed to standard error as one ``spans: {...}``
line: every span's device ms, glue ms and operations a step, the ten
longest idle gaps named by the device span open across each and the
innermost host span at its middle, the graph captures made in the
window, and busy ms and operations a step beside the first traced
window's (what the spans cost when on).

The harness hands a reader the reading only: the scene is the reading's,
the device the scene's, and the cell (its traffic and loop) is read from
the frame of ``runner.run_cell`` that called it. Where the program has no
spans (an older program), or no such frame or cell is found (a reading
made elsewhere, or a runner whose locals are named otherwise), every
reader of the spans reads None.
"""

from __future__ import annotations

import collections
import inspect
import json
import re
import sys

import torch

from benchlib import runner, trace

# the names the program gives its spans on the profiler's clock: host
# records "trt/<name>", device marker kernels trt_span_marker<id, open>
HOST_PREFIX = "trt/"
MARKER = "trt_span_marker"
_MARKER_ARGS = re.compile(
    MARKER + r"<\s*(?:\(int\))?\s*(\d+)\s*,\s*(?:\(int\))?\s*(\d+)\s*>")
# the layers a window is split into; "outside" is every operation in none
# of them (the step's own work, the copies)
LAYERS = ("setup", "binning", "raster", "untile")


def marker(name: str, names):
    """(span name, opening) of a marker kernel's profiler name, by the
    program's id table ``names`` (``timing.DEVICE_SPANS``), else None."""
    m = _MARKER_ARGS.search(name)
    if m is None:
        return None
    sid = int(m.group(1))
    if sid >= len(names):
        raise ValueError(f"marker {name!r} names span id {sid}, which "
                         f"the program's DEVICE_SPANS does not hold")
    return names[sid], m.group(2) != "0"


def layer_of(span_name) -> str:
    """The layer a device span's operations count to: its name without
    ``.bwd``, or "outside" for "step" and for no span."""
    if span_name is None:
        return "outside"
    base = span_name.removesuffix(".bwd")
    return base if base in LAYERS else "outside"


def split(device, cpu, steps: int, is_own, names, top: int = 10):
    """Split a profiled window of ``steps`` steps by the program's spans.

    device: [(name, start_us, end_us)] device operations, markers and the
    profiler's ``trt/`` annotations among them; cpu: [(name, start_us,
    end_us)] host events; names: the program's span id table. Every
    operation counts to the innermost device span open when it starts
    (self time: a child span's operations are the child's). Returns None
    when the markers do not pair up, a marker closes a span that is not
    open, or a marker is not recorded the same number of times each step.
    Else a dict of ms and operations a step:

    spans: {span: {device_ms, glue_ms, ops}}, "outside" for no span;
    layers: {layer: glue_ms} for LAYERS and "outside" (their sum is the
        window's glue);
    glue_ms, busy_ms, ops, markers: the window's, a step;
    idle_gaps: the ``top`` longest gaps between device operations, each
        [device span open there or None, innermost ``trt/`` host span at
        its middle or None, ms].
    """
    events = sorted((a, b, n) for n, a, b in device
                    if not n.startswith(HOST_PREFIX))
    opened: list = []
    seen: collections.Counter = collections.Counter()
    spans: dict = {}
    gaps, end, n_ops = [], None, 0  # gaps: (start, end, span open across)
    for a, b, n in events:
        if end is not None and a > end:
            gaps.append((end, a, opened[-1] if opened else None))
        end = b if end is None else max(end, b)
        m = marker(n, names)
        if m is not None:
            name, opening = m
            seen[m] += 1
            if opening:
                opened.append(name)
            elif name in opened:
                del opened[len(opened) - 1 - opened[::-1].index(name)]
            else:
                return None
            continue
        n_ops += 1
        row = spans.setdefault(opened[-1] if opened else "outside",
                               {"device_ms": 0.0, "glue_ms": 0.0, "ops": 0})
        row["device_ms"] += (b - a) / 1e3
        row["ops"] += 1
        if not is_own(n):
            row["glue_ms"] += (b - a) / 1e3
    if opened or not seen or any(v % steps for v in seen.values()) or \
            any(seen[(k, True)] != seen[(k, False)] for k, _ in seen):
        return None
    for row in spans.values():
        row["device_ms"] /= steps
        row["glue_ms"] /= steps
        row["ops"] /= steps
    layers = {k: 0.0 for k in LAYERS + ("outside",)}
    for name, row in spans.items():
        layers[layer_of(None if name == "outside" else name)] += \
            row["glue_ms"]
    return {"spans": spans, "layers": layers,
            "glue_ms": sum(layers.values()),
            "busy_ms": trace.union_s([(n, a, b) for a, b, n in events])
            * 1e3 / steps,
            "ops": n_ops / steps,
            "markers": sum(seen.values()) / steps,
            "idle_gaps": _name_gaps(gaps, cpu, top)}


def _name_gaps(gaps, cpu, top: int) -> list:
    """The ``top`` longest gaps, each [the device span open across it, the
    innermost ``trt/`` host span at its middle, ms]."""
    host = [(e - s, n, s, e) for n, s, e in cpu if n.startswith(HOST_PREFIX)]
    named = []
    for a, b, inner in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (a + b) / 2
        under = [(d, n) for d, n, s, e in host if s <= mid <= e]
        named.append([inner, min(under)[1][len(HOST_PREFIX):]
                      if under else None, (b - a) / 1e3])
    return named


class _Ahead:
    """loop.step(i) with at most ``ahead`` steps dispatched ahead of the
    device: before issuing a step the host waits for the step ``ahead``
    before it to complete (an event ring made before the window, as
    ``window.run`` keeps one)."""

    def __init__(self, loop, ahead: int):
        self.loop, self.issued = loop, 0
        self.ring = [torch.cuda.Event() for _ in range(ahead)]

    def step(self, i: int) -> None:
        slot = self.ring[self.issued % len(self.ring)]
        if self.issued >= len(self.ring):
            slot.synchronize()
        self.loop.step(i)
        slot.record()
        self.issued += 1


def _run_cell_cell():
    """The cell of the ``runner.run_cell`` call under way, or None."""
    frame = inspect.currentframe()
    while frame is not None:
        if frame.f_code is runner.run_cell.__code__:
            c = frame.f_locals.get("c")
            return c if isinstance(c, dict) else None
        frame = frame.f_back
    return None


def _timing():
    """The program's spans module, or None where it has no spans."""
    try:
        from torch_renderer_tpu_torch.utils import timing
    except ImportError:
        return None
    return timing if hasattr(timing, "DEVICE_SPANS") else None


def window(reading):
    """The spans window's split (``split``) of this traced run, made once
    and kept on the reading; None where it cannot be read."""
    if not hasattr(reading, "spans"):
        reading.spans = _profile(reading)
    return reading.spans


def _profile(reading):
    timing = _timing()
    c = _run_cell_cell()
    scene = getattr(reading, "_scene", None)
    if timing is None or c is None or not reading.steps or \
            not isinstance(scene, dict) or "verts" not in scene:
        return None
    traffic, dev = c.get("traffic"), scene["verts"].device
    if not isinstance(traffic, dict) or "loop" not in c:
        return None
    before = timing.enable_spans(True)
    loop = None
    try:
        loop = c["loop"].Loop(scene, traffic, dev)
        for i in range(traffic["warmup_steps"]):
            loop.step(i)
        captures = timing.counters()["captures"]
        traced = trace.profile(_Ahead(loop, traffic["ahead"]),
                               reading.steps.start, len(reading.steps))
        captures = timing.counters()["captures"] - captures
    finally:
        timing.enable_spans(before)
        if loop is not None:
            runner.release(loop, dev.type == "cuda")
    steps = len(reading.steps)
    out = split(traced["device"], traced["cpu"], steps, reading.is_own,
                timing.DEVICE_SPANS)
    print("spans: " + json.dumps({
        "split": out, "captures": captures,
        "marks_kept": traced["marks"], "attempts": traced["attempts"],
        "busy_ms": {"spans_on": out and out["busy_ms"],
                    "spans_off": reading.busy_s * 1e3 / steps},
        "ops": {"spans_on": out and out["ops"],
                "spans_off": len(reading.device) / steps}}),
        file=sys.stderr, flush=True)
    return out


def layer_glue_ms(reading, layer: str):
    """Device ms a step of glue in the layer's spans, forward and
    backward, self time."""
    out = window(reading)
    return None if out is None else out["layers"][layer]

"""Device-accurate timing, profiling, and the program's spans and counters
(PyTorch counterpart of ``torch_renderer_tpu.utils.timing``).

Timing: ``time_fn`` runs a function once (the first call builds the kernels
and warms the allocator), warms it, synchronizes every CUDA device its
output lives on and reports per-call statistics; ``StageTimer`` gives a
per-stage wall-clock breakdown; ``profiler_trace`` writes a torch.profiler
Chrome trace. The printout is the JAX package's.

Spans (``span(name, on)``), off by default (``enable_spans``): when off a
call is one flag test and returns a shared null context that does nothing.
When on, a span is a host record named ``trt/<name>`` (the record
``torch.profiler.record_function`` makes, by its fast path) and, for work
on a CUDA device, a one-thread marker kernel (``csrc/spans.cu``
``trt_span_marker<id, open>``) on the current stream at entry and at exit,
so the profiler's own kernel records name the span on the device's clock.
Under CUDA graph capture each marker is a node of the graph: every replay
records its spans, with no host involvement. A graph shows spans only if it
was captured with spans on. ``Span.inputs`` / ``Span.outputs`` place
identity autograd Functions on the differentiable tensors entering and
leaving the span (when on only), whose backward opens and closes
``<name>.bwd`` the same way.

Counters (``count(name)``, ``counters()``) count events on the host: the
kernel wrappers' launches (eager calls, warm-ups and captures; a replay
launches from its graph and counts nothing), the captured calls' bodies
run from the host, and ``captures`` (graph captures made by StepGraph).
The benchmark reads a profiled window back into the spans
(``benchmark/benchlib/spans.py``) by DEVICE_SPANS and MARKER.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional

import torch


def synchronize(out) -> None:
    """Wait for every CUDA device that holds a tensor of ``out`` (a tensor,
    or lists, tuples and dicts of them); CPU tensors need no wait."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)

    walk(out)
    for d in devices:
        torch.cuda.synchronize(d)


@dataclasses.dataclass
class TimingResult:
    name: str
    mean_s: float
    min_s: float
    max_s: float
    reps: int
    compile_s: float

    def __str__(self) -> str:
        return (
            f"{self.name}: mean {self.mean_s * 1e3:.3f} ms  "
            f"min {self.min_s * 1e3:.3f} ms  max {self.max_s * 1e3:.3f} ms  "
            f"(n={self.reps}, compile {self.compile_s:.2f} s)"
        )


def time_fn(fn: Callable, *args, reps: int = 20, warmup: int = 1,
            name: str = "fn") -> TimingResult:
    """Time fn(*args) with device synchronization; compile_s is the first
    call (kernel build and first launch included)."""
    t0 = time.perf_counter()
    synchronize(fn(*args))
    compile_s = time.perf_counter() - t0
    for _ in range(max(warmup - 1, 0)):
        synchronize(fn(*args))

    samples: List[float] = []
    for _ in range(reps):
        t0 = time.perf_counter()
        synchronize(fn(*args))
        samples.append(time.perf_counter() - t0)
    return TimingResult(
        name=name, mean_s=sum(samples) / len(samples),
        min_s=min(samples), max_s=max(samples), reps=reps, compile_s=compile_s,
    )


class StageTimer:
    """Per-stage wall-clock breakdown (H2D, render, backward, ...)."""

    def __init__(self):
        self.stages: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            synchronize(sync)
        self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.stages.values())
        lines = [
            f"  {k}: {v * 1e3:.2f} ms ({100 * v / total:.1f}%)"
            for k, v in self.stages.items()
        ]
        return "\n".join([f"total {total * 1e3:.2f} ms"] + lines)


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str] = None):
    """torch.profiler trace of the block (CPU, plus CUDA when a device is
    visible), written as a Chrome trace to log_dir/trace.json, with spans
    on for the block (a CUDA graph replayed in it shows its spans only if
    it was captured with spans on); a no-op without log_dir."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    before = enable_spans(True)
    try:
        with profile(activities=acts) as prof:
            yield
    finally:
        enable_spans(before)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------

_COUNTS: collections.Counter = collections.Counter()


def count(name: str, n: int = 1) -> None:
    """Add n to the host counter ``name``."""
    _COUNTS[name] += n


def counters() -> collections.Counter:
    """A copy of every counter (a name never counted reads 0)."""
    return collections.Counter(_COUNTS)


def reset_counters() -> None:
    _COUNTS.clear()


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

# Spans with a device marker, by id: the id is the marker kernel's first
# template argument (csrc/spans.cu takes ids below 16).
DEVICE_SPANS = ("step", "setup", "setup.bwd", "binning", "raster",
                "raster.bwd", "untile", "untile.bwd")
SPAN_IDS = {name: i for i, name in enumerate(DEVICE_SPANS)}
HOST_PREFIX = "trt/"
MARKER = "trt_span_marker"

_SPANS_ON = False


def enable_spans(on: bool = True) -> bool:
    """Turn spans on or off; returns the previous setting."""
    global _SPANS_ON
    before, _SPANS_ON = _SPANS_ON, bool(on)
    return before


def spans_enabled() -> bool:
    return _SPANS_ON


class _NullSpan:
    """The span when spans are off: enters, exits and passes its tensors
    through unchanged."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def inputs(self, *xs):
        return xs[0] if len(xs) == 1 else xs

    outputs = inputs


_NULL = _NullSpan()


def span(name: str, on=None):
    """The span ``name`` as a context manager: host only when ``on`` is
    None, else also on the device of ``on`` (a tensor or a device) when it
    is a CUDA device. Names with a device marker are DEVICE_SPANS."""
    if not _SPANS_ON:
        return _NULL
    return Span(name, on)


def _cuda_index(on):
    """The CUDA device index of a tensor or device, else None."""
    if on is None:
        return None
    device = on.device if isinstance(on, torch.Tensor) else torch.device(on)
    if device.type != "cuda":
        return None
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _host_record(name: str):
    """An entered host record ``trt/<name>`` on the profiler's clock,
    closed by ``.__exit__(None, None, None)``; about 0.4 µs while no
    profiler runs (record_function's operator call costs tens of µs)."""
    record = torch._C._profiler._RecordFunctionFast(HOST_PREFIX + name)
    record.__enter__()
    return record


def _mark(sid: int, opening: bool, index) -> None:
    from .._build import launch

    launch("trt_span_marker_launch", sid, int(opening),
           device=torch.device("cuda", index))


class _Ends:
    """The host record and device marker of one span's backward
    (``<name>.bwd``), shared by its two boundary Functions."""

    def __init__(self, name: str, index):
        self.name, self.sid = name, SPAN_IDS.get(name)
        self.index = index if self.sid is not None else None
        self.record = None

    def open(self) -> None:
        self.record = _host_record(self.name)
        if self.index is not None:
            _mark(self.sid, True, self.index)

    def close(self) -> None:
        if self.index is not None:
            _mark(self.sid, False, self.index)
        if self.record is not None:
            self.record.__exit__(None, None, None)
            self.record = None


class _BackwardCloses(torch.autograd.Function):
    """Identity on a span's inputs; its backward, the last of the span's
    backward, closes ``<name>.bwd``."""

    @staticmethod
    def forward(ctx, ends, *xs):
        ctx.ends = ends
        ctx.set_materialize_grads(False)   # an unused output stays unused
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.ends.close()
        return (None,) + grads


class _BackwardOpens(torch.autograd.Function):
    """Identity on a span's outputs; its backward, the first of the span's
    backward, opens ``<name>.bwd``."""

    @staticmethod
    def forward(ctx, ends, *xs):
        ctx.ends = ends
        ctx.set_materialize_grads(False)   # an unused output stays unused
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.ends.open()
        return (None,) + grads


def _differentiable(x, out: list) -> None:
    """The tensors of x (tensors, dataclasses, tuples, lists and dicts of
    them) that require a gradient, into out."""
    if isinstance(x, torch.Tensor):
        if x.requires_grad:
            out.append(x)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            if f.init:
                _differentiable(getattr(x, f.name), out)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _differentiable(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _differentiable(v, out)


def _replace(x, swap: dict):
    """x's structure with each tensor t replaced by swap[id(t)] where
    present."""
    if isinstance(x, torch.Tensor):
        return swap.get(id(x), x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _replace(getattr(x, f.name), swap)
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, tuple) and hasattr(x, "_fields"):      # NamedTuple
        return type(x)._make(_replace(v, swap) for v in x)
    if isinstance(x, (tuple, list)):
        return type(x)(_replace(v, swap) for v in x)
    if isinstance(x, dict):
        return {k: _replace(v, swap) for k, v in x.items()}
    return x


class Span:
    """An open span (spans on): see ``span``."""

    def __init__(self, name: str, on):
        self.name = name
        self.sid = SPAN_IDS.get(name)
        self.index = _cuda_index(on) if self.sid is not None else None
        self.ends = None

    def __enter__(self):
        self.record = _host_record(self.name)
        if self.index is not None:
            _mark(self.sid, True, self.index)
        return self

    def __exit__(self, *exc):
        if self.index is not None:
            _mark(self.sid, False, self.index)
        self.record.__exit__(None, None, None)
        return False

    def _through(self, xs, fn):
        if not torch.is_grad_enabled():
            return xs
        grads: list = []
        _differentiable(xs, grads)
        if not grads:
            return xs
        outs = fn.apply(self.ends, *grads)
        return _replace(xs, {id(g): o for g, o in zip(grads, outs)})

    def inputs(self, *xs):
        """xs (tensors, or structures of them) with an identity Function on
        every tensor that requires a gradient: its backward closes
        ``<name>.bwd``."""
        self.ends = _Ends(self.name + ".bwd", self.index)
        out = self._through(xs, _BackwardCloses)
        if out is xs:
            self.ends = None
        return out[0] if len(out) == 1 else out

    def outputs(self, *xs):
        """xs with an identity Function on every tensor that requires a
        gradient, whose backward opens ``<name>.bwd``; only where the
        span's inputs were given theirs (so every open has its close)."""
        out = xs if self.ends is None else self._through(xs, _BackwardOpens)
        return out[0] if len(out) == 1 else out

"""Utilities of the port (counterpart of ``torch_renderer_tpu.utils``):
the timing and profiling harness, and the captured-step runner of the
loops (``utils.graph``)."""

from .graph import StepGraph, resolve_capture
from .timing import StageTimer, TimingResult, profiler_trace, time_fn

__all__ = ["StageTimer", "StepGraph", "TimingResult", "profiler_trace",
           "resolve_capture", "time_fn"]

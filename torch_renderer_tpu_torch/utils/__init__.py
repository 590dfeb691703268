"""Utilities of the port (counterpart of ``torch_renderer_tpu.utils``):
so far the timing and profiling harness."""

from .timing import StageTimer, TimingResult, profiler_trace, time_fn

__all__ = ["StageTimer", "TimingResult", "profiler_trace", "time_fn"]

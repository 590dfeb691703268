"""Utilities of the port (counterpart of ``torch_renderer_tpu.utils``):
checkpoints, numerical-safety instrumentation, metric logging, the timing
and profiling harness, and the captured-step runner of the loops
(``utils.graph``)."""

from .checkpoint import export_mesh_snapshot, load_checkpoint, save_checkpoint
from .debug import anomaly_detection, checked, checked_budgets
from .graph import StepGraph, resolve_capture
from .metrics import MetricLogger
from .timing import StageTimer, TimingResult, profiler_trace, time_fn

__all__ = ["MetricLogger", "StageTimer", "StepGraph", "TimingResult",
           "anomaly_detection", "checked", "checked_budgets",
           "export_mesh_snapshot", "load_checkpoint", "profiler_trace",
           "resolve_capture", "save_checkpoint", "time_fn"]

"""Device-accurate timing and profiling harness (PyTorch counterpart of
``torch_renderer_tpu.utils.timing``).

A small utility that runs a function once (the first call builds the
kernels and warms the allocator), warms it, synchronizes every CUDA device
its output lives on and reports per-call statistics, a per-stage
wall-clock breakdown, and a hook into torch.profiler for real traces. The
printout is the JAX package's.
"""

from __future__ import annotations

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
    visible), written as a Chrome trace to log_dir/trace.json; a no-op
    without log_dir."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

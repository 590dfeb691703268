"""The traced window: ``steps`` steps of the loop under ``torch.profiler``,
read into what the per-layer metrics need.

A profiler window can lose the records of the first kernels after it
starts (the port's ``PERF.md``: windows lost 3 to more than 64 of them).
So every window opens with MARKS marker kernels (int16 fills) and a
synchronise before the steps: the loss falls on the markers, which are
left out of every count, and a window that kept none of its markers is
profiled again, up to WINDOWS times. Frozen copy of ``chip_smoke.py``
``kernel_counts`` / ``full_window`` (``:2752-2815``).

The port's own kernels are found by reading its sources: every
``__global__`` function under ``csrc/`` and every ``@triton.jit`` function,
so a kernel a later change adds counts as the port's without an edit here.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

import torch

MARKS = 256
MARK_NAME = "FillFunctor<short>"
WINDOWS = 3
# annotation spans the profiler lists among the device's events
ANNOTATIONS = ("Optimizer.", "ProfilerStep")


def own_kernel_names(package: str = "torch_renderer_tpu_torch") -> set:
    """The identifiers of the program's own device kernels."""
    root = Path(importlib.util.find_spec(package).origin).parent
    names = set()
    glob = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                      r"\s*)?([A-Za-z_]\w*)\s*[(<]")
    jit = re.compile(r"@triton\.jit[^\n]*\n(?:\s*@[^\n]*\n)*\s*def\s+"
                     r"([A-Za-z_]\w*)")
    for path in root.rglob("*"):
        if path.suffix in (".cu", ".cuh"):
            names.update(glob.findall(path.read_text()))
        elif path.suffix == ".py":
            text = path.read_text()
            if "triton" in text:
                names.update(jit.findall(text))
    return names


def has_name(kernel: str, ident: str) -> bool:
    """Whether the profiler's kernel name holds the identifier whole."""
    return re.search(rf"(?<![A-Za-z0-9_]){re.escape(ident)}(?![A-Za-z0-9_])",
                     kernel) is not None


def short(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:120]


def profile(loop, first: int, steps: int) -> dict:
    """Profile loop.step(first) ... loop.step(first + steps - 1). Returns
    the device events (name, start_us, end_us) without the markers, the
    window_s they lie in, by the profiler's own clock (from the end of
    the last marker kept to the end of the last device event), the CPU
    events (name, start_us, end_us) and the markers kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    marks = torch.empty(MARKS, dtype=torch.int16, device="cuda")
    for attempt in range(WINDOWS):
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            for i in range(MARKS):
                marks[i].fill_(1)
            torch.cuda.synchronize()
            for i in range(first, first + steps):
                loop.step(i)
            torch.cuda.synchronize()
        events = prof.events()
        device = [(e.name, e.time_range.start, e.time_range.end)
                  for e in events if e.device_type == DeviceType.CUDA
                  and not e.name.startswith(ANNOTATIONS)]
        kept = sum(MARK_NAME in n for n, _, _ in device)
        first += steps
        if kept:
            break
    cpu = [(e.name, e.time_range.start, e.time_range.end) for e in events
           if e.device_type == DeviceType.CPU]
    ops = [d for d in device if MARK_NAME not in d[0]]
    start = max((b for n, _, b in device if MARK_NAME in n),
                default=min(a for _, a, _ in ops))
    early = [d for d in ops if d[1] < start]
    if early:
        raise RuntimeError(
            f"{len(early)} device operations of the traced steps begin "
            f"before the opening markers end (first: {early[0]}): the "
            "trace's records or its clock are at fault")
    window = (max(b for _, _, b in ops) - start) / 1e6
    return {"device": ops, "cpu": cpu, "window_s": window, "marks": kept,
            "attempts": attempt + 1, "next": first}


def union_s(events) -> float:
    """Seconds covered by the events' spans (their union)."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted((s, e) for _, s, e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def breakdown(device, cpu, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps between device operations, each named by the innermost host
    operation under way at the gap's middle."""
    per: dict = {}
    for name, a, b in device:
        per[short(name)] = per.get(short(name), 0.0) + (b - a) / 1e6
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    gaps, end = [], None
    for a, b in sorted((s, e) for _, s, e in device):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        under = [(e - s, n) for n, s, e in cpu if s <= mid <= e]
        named.append([min(under)[1] if under else "no host op recorded",
                      (b - a) / 1e6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}

"""Faults planted under the timed path, for the checks that ``correct``
must fail: a step that leaves its state unchanged, half of the batch left
out, an answer altered where it is produced. Each is patched into the
program before the loop is built, so a captured step captures it.

Used by ``tests/test_benchmark_faults.py`` at small scenes on the CPU and
by ``control.py --fault`` at a cell's own size on the card. (No cell has
an exchange between cards. In the calls of all 120 views every call
renders the same views, so an answer left unchanged from the call before
is the right one there, and that cell has no such fault.)
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

NAMES = ("unchanged", "half", "altered")


def _half(x):
    keep = torch.ones(x.shape[0], 1, 1, dtype=x.dtype, device=x.device)
    keep[x.shape[0] // 2:] = 0
    return x * keep


def _altered(x):
    """The first view's answer moved by 1e-2 where it is not 0."""
    return torch.cat([x[:1] + 1e-2 * (x[:1] > 0), x[1:]])


def _stale():
    first = []

    def change(x):
        if not first:
            first.append(x.clone())
        return first[0]
    return change


def _zero_backward(ctx, g):
    q = ctx.saved_tensors[0]
    return torch.zeros_like(q), None, None, None, None


def applies(workload: str, fault: str) -> bool:
    return (workload, fault) != ("depth-ico3-720p.calls120", "unchanged")


@contextlib.contextmanager
def plant(workload: str, fault: str | None):
    """The program with ``fault`` planted for ``workload`` (None: as it
    is)."""
    if fault is None:
        yield
        return
    if fault not in NAMES or not applies(workload, fault):
        raise ValueError(f"no fault {fault!r} for {workload!r}")
    from torch_renderer_tpu_torch.rasterize import cuda_soft
    from torch_renderer_tpu_torch.renderer import DepthRender

    soft = workload.startswith("softsil")
    if soft and fault == "unchanged" and workload.endswith(".fit"):
        # the step's gradient comes back zero: the vertices never move
        patch = mock.patch.object(cuda_soft.SoftCoverage, "backward",
                                  staticmethod(_zero_backward))
    else:
        change = {"unchanged": _stale(), "half": _half,
                  "altered": _altered}[fault]
        if soft:
            real = cuda_soft.soft_silhouette_fd

            def broken(*args, **kw):
                return change(real(*args, **kw))
            patch = mock.patch.object(cuda_soft, "soft_silhouette_fd",
                                      broken)
        else:
            real = DepthRender.render

            def broken(self, *args, **kw):
                return change(real(self, *args, **kw))
            patch = mock.patch.object(DepthRender, "render", broken)
    with patch:
        yield

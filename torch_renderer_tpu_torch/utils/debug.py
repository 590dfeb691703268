"""Numerical-safety instrumentation (PyTorch counterpart of
``torch_renderer_tpu.utils.debug``; the reference calls
torch.autograd.set_detect_anomaly(True), camera_pose_optimizer.py:56).

  * anomaly_detection(): torch's anomaly mode (a backward that makes a NaN
    raises, with the forward op's trace) plus a forward check that raises
    at the op that first makes a NaN or an Inf, as jax_debug_nans and
    jax_debug_infs do; both are restored on exit.
  * checked(fn): fn with the forward NaN check, raising on the host.
  * checked_budgets(fn): fn with the binned paths' check_budgets=
    "checkify" guards, raising BudgetOverflowError after the call.

The forward check reads every op's output back to the host: it is a
debugging tool, not for timed runs, and it cannot run inside a captured
CUDA graph.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class _FloatCheck(TorchDispatchMode):
    """Raise FloatingPointError at the first op whose floating output holds
    a NaN (nans) or an Inf (infs). Ops that allocate without writing
    (empty and kin) are not checked."""

    def __init__(self, nans: bool, infs: bool):
        super().__init__()
        self.nans, self.infs = nans, infs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if "empty" in func.__name__:
            return out
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor) or not (
                    t.is_floating_point() or t.is_complex()):
                continue
            if self.nans and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN produced by {func}")
            if self.infs and bool(torch.isinf(t).any()):
                raise FloatingPointError(f"Inf produced by {func}")
        return out


@contextlib.contextmanager
def anomaly_detection(nans: bool = True, infs: bool = True):
    """Raise at the op that first makes a NaN (nans) or Inf (infs) in the
    forward, and turn on torch's anomaly mode for the backward; the
    anomaly flag is restored on exit."""
    before = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(bool(nans or infs))
    try:
        with _FloatCheck(nans, infs):
            yield
    finally:
        torch.autograd.set_detect_anomaly(before)


def checked(fn: Callable, *, jit: bool = True) -> Callable:
    """fn whose call raises FloatingPointError when an op makes a NaN (the
    JAX package's checkify float checks). jit is accepted for the JAX
    signature and has no effect."""
    del jit

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _FloatCheck(nans=True, infs=False):
            return fn(*args, **kwargs)

    return wrapper


def checked_budgets(fn: Callable, *, jit: bool = True) -> Callable:
    """fn under the binned paths' check_budgets="checkify" guards
    (RasterizationSettings, PointsRasterizationSettings and the soft
    silhouette's entries): the counts are recorded on the device during
    the call, and at its end the call raises
    rasterize.binning.BudgetOverflowError, naming the budget, when a
    silent-drop budget (face or point bins, active tiles, group lanes, the
    occupancy split's tail) overflowed. With "warn" no wrapper is needed.
    jit is accepted for the JAX signature and has no effect."""
    from ..rasterize.binning import checked_budget_checks

    del jit

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with checked_budget_checks():
            out = fn(*args, **kwargs)
        return out

    return wrapper

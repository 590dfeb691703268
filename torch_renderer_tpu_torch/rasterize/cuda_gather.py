"""Tile-slab gather through a hand-written CUDA kernel pair (PyTorch
counterpart of ``torch_renderer_tpu.rasterize.pallas_gather``).

``gather_tiles(idx, table)`` takes per-tile slot ids idx (B, T, S) (int32
or int64; -1, or any id outside [0, F), marks an empty slot) and a
per-item channel table (B, F, C) float32, and returns the slab
(B, T, S, C): each slot's table row, exactly 0 in empty slots. It is
differentiable with respect to table: the backward scatters the slab's
cotangent back onto the rows the slots hold.

This is the load stage of every binned path: the hard raster's and the
point raster's candidate slabs (binning.tile_channel_slabs) and the soft
silhouette's corner slabs (cuda_soft.tile_slabs, the one that carries a
gradient).

For each kernel the module keeps its plain PyTorch version
(``gather_tiles_reference``: index, then mask; ``gather_tiles_bwd_reference``:
``scatter_add_``): a wrapper uses it for a tensor on the CPU, launches the
kernel for a CUDA tensor, and raises for anything else. The forward
kernel's launch plan (``gather_plan``) is made here, on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._build import launch

# Kernel launches since import (or since a caller reset them): one per
# launched kernel, counted where the wrapper launches it and nowhere else.
GATHER_FWD_LAUNCHES = 0
GATHER_BWD_LAUNCHES = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the kernels
# ---------------------------------------------------------------------------

def _live_ids(idx: torch.Tensor, F: int):
    """(live mask, ids clamped into [0, F)) of idx (B, T, S)."""
    live = (idx >= 0) & (idx < F)
    return live, torch.where(live, idx, torch.zeros_like(idx)).long()


def gather_tiles_reference(idx: torch.Tensor,
                           table: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward kernel: (B, T, S, C), table rows at
    live slots, 0 elsewhere."""
    B, T, S = idx.shape
    F, C = table.shape[1], table.shape[2]
    live, ids = _live_ids(idx, F)
    out = table.gather(1, ids.reshape(B, T * S, 1).expand(B, T * S, C))
    out = out.reshape(B, T, S, C)
    return torch.where(live[..., None], out, torch.zeros_like(out))


def gather_tiles_bwd_reference(idx: torch.Tensor, g: torch.Tensor,
                               F: int) -> torch.Tensor:
    """Plain version of the backward kernel: dtable (B, F, C) = the sum of
    g[b, t, s, :] over the live slots that hold each row."""
    B, T, S, C = g.shape
    live, ids = _live_ids(idx, F)
    src = torch.where(live[..., None], g, torch.zeros_like(g))
    dtable = g.new_zeros((B, F, C))
    return dtable.scatter_add_(1, ids.reshape(B, T * S, 1).expand(
        B, T * S, C), src.reshape(B, T * S, C))


# ---------------------------------------------------------------------------
# The forward kernel's launch plan
# ---------------------------------------------------------------------------

MAX_FWD_THREADS = 256   # a forward block's threads at most


class GatherPlan(NamedTuple):
    """How the forward kernel covers the slab's rows (one row per (b, t):
    its S * C floats, contiguous), each thread writing 4 floats with one
    16-byte store."""

    threads: int   # threads a block, a multiple of 32
    chunks: int    # blocks sharing a row


def gather_plan(S: int, C: int) -> GatherPlan:
    """The forward kernel's plan for rows of S slots of C floats: as many
    threads as the row has 16-byte units, up to MAX_FWD_THREADS (whole
    warps, one at least), and enough blocks to cover the row."""
    units = S * C // 4
    threads = min(MAX_FWD_THREADS, max(32, -(-units // 32) * 32))
    return GatherPlan(threads, max(1, -(-units // threads)))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_idx(idx: torch.Tensor, other: torch.Tensor, name: str):
    if idx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no gather kernel for device {idx.device}")
    if idx.dtype not in (torch.int32, torch.int64) or idx.ndim != 3:
        raise ValueError(f"idx must be int32 or int64 (B, T, S), got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if other.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {other.dtype}")
    if other.device != idx.device:
        raise ValueError(f"idx and {name} must be on one device")
    if idx.device.type == "cuda" and not (idx.is_contiguous()
                                          and other.is_contiguous()):
        raise ValueError("the CUDA kernels take contiguous tensors")


def gather_tiles_fwd(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The forward kernel: (B, T, S, C) slab of table (B, F, C) rows."""
    global GATHER_FWD_LAUNCHES
    _check_idx(idx, table, "table")
    B, T, S = idx.shape
    if table.ndim != 3 or table.shape[0] != B:
        raise ValueError(f"table must be ({B}, F, C), got "
                         f"{tuple(table.shape)}")
    if idx.device.type == "cpu":
        return gather_tiles_reference(idx, table)
    F, C = table.shape[1], table.shape[2]
    out = table.new_empty((B, T, S, C))      # the kernel writes every element
    if out.numel() == 0:
        return out
    if F == 0:
        return out.zero_()
    launch("trt_gather_tiles_fwd", idx.data_ptr(),
           int(idx.dtype == torch.int64), table.data_ptr(), out.data_ptr(), B,
           T, S, F, C, *gather_plan(S, C), device=idx.device)
    GATHER_FWD_LAUNCHES += 1
    return out


def gather_tiles_bwd(idx: torch.Tensor, g: torch.Tensor,
                     F: int) -> torch.Tensor:
    """The backward kernel: dtable (B, F, C) from the slab cotangent g
    (B, T, S, C), in one launch that zeroes dtable and then adds; float32
    atomics sum a row's terms in an order that changes from run to run."""
    global GATHER_BWD_LAUNCHES
    _check_idx(idx, g, "g")
    B, T, S = idx.shape
    if g.ndim != 4 or tuple(g.shape[:3]) != (B, T, S):
        raise ValueError(f"g must be ({B}, {T}, {S}, C), got "
                         f"{tuple(g.shape)}")
    if idx.device.type == "cpu":
        return gather_tiles_bwd_reference(idx, g, F)
    C = g.shape[3]
    dtable = g.new_empty((B, F, C))          # the kernel writes every element
    if dtable.numel() == 0:
        return dtable
    launch("trt_gather_tiles_bwd", idx.data_ptr(),
           int(idx.dtype == torch.int64), g.data_ptr(), dtable.data_ptr(), B,
           T * S, F, C, device=idx.device)
    GATHER_BWD_LAUNCHES += 1
    return dtable


class GatherTiles(torch.autograd.Function):
    """The kernel pair as one differentiable op: table -> slab, gradient to
    table."""

    @staticmethod
    def forward(ctx, idx, table):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[1]
        return gather_tiles_fwd(idx, table)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        if not ctx.needs_input_grad[1]:
            return None, None
        return None, gather_tiles_bwd(idx, g.contiguous(), ctx.n_rows)


def gather_tiles(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(B, T, S) slot ids (-1 = empty) x (B, F, C) float32 table ->
    (B, T, S, C) slab, empty slots exactly 0; differentiable with respect
    to table."""
    return GatherTiles.apply(idx, table)

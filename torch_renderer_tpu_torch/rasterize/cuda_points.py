"""Tile-binned point-splat rasterization through a hand-written CUDA
selection kernel (PyTorch counterpart of the binned path of
``torch_renderer_tpu.rasterize.points`` and of
``torch_renderer_tpu.rasterize.pallas_points``).

The path: bin points into active tiles by their radius-expanded bbox
(binning.bin_ranks_active; with no active-tile budget every tile gets a
slot), gather each tile's candidates into (B, A, Pmax, C) slabs (x, y, z,
plus r^2 only with a per-point radius, plus the global point id) with an
int32 count per tile, run ``points_select`` on the detached slab, gather
the winners' channels by point id, scatter the per-tile fields back to the
tile grid with the background (-1 idx, -1 zbuf, -1 dists2, 0 features) and
untile into (B, H, W, K) PointFragments.

A point covers a pixel when dx^2 + dy^2 <= r^2, its slot is below the
tile's capped count and its z is above znear; each pixel keeps its K
covering points of lowest z, ties to the lower slot (the lower point id).
The pixel sits at origin + off with off a row of
binning.tile_pixel_coords, the same offsets the differentiable epilogue
adds, and the kernel evaluates the coverage test in the plain version's
order with round-to-nearest intrinsics, so a boundary pixel is decided bit
for bit as the epilogue's recomputed d^2 says.

Gradients: selection is not differentiable and the kernel has no backward,
as the JAX package has none. The winners' x, y, z (and any extra channels)
are gathered from the differentiable per-point channels by point id with
``torch.gather``, whose backward is a scatter-add, and d^2 is recomputed
from the gathered x and y.

The module keeps the kernel's plain PyTorch version
(``points_select_reference``): the wrapper uses it for a tensor on the CPU,
launches the kernel for a CUDA tensor, and raises for anything else.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .._build import launch
from .binning import (
    ActiveBins,
    bin_ranks_active,
    check_budget,
    scatter_active_bg,
    tile_channel_slabs,
    tile_grid,
    tile_pixel_coords,
    untile_image,
)
from .points import INF, PointFragments

# Kernel launches since import (or since a caller reset them): one per
# launched kernel, counted where the wrapper launches it and nowhere else.
POINTS_LAUNCHES = 0

MAX_TILE = 32            # tile^2 <= 1024 pixels per tile
MAX_K = 64               # points_select keeps at most this many points a pixel


# ---------------------------------------------------------------------------
# The plain PyTorch version of the kernel
# ---------------------------------------------------------------------------

def _priority(slab, count, origin, offs, znear: float, r2):
    """Camera z (B, A, tile^2, P') of every (pixel, slot) pair whose point
    covers the pixel, INF elsewhere, in the kernel's arithmetic order. Slots
    at or beyond the largest count are never live, so only the first
    max(count) slots are evaluated (at least one)."""
    slab = slab[:, :, :max(1, int(count.max()))]
    px = (offs[:, 0] + origin[..., 0:1])[..., None]           # (B, A, tp, 1)
    py = (offs[:, 1] + origin[..., 1:2])[..., None]
    x, y, z = (slab[:, :, None, :, c] for c in range(3))      # (B, A, 1, P)
    dx = px - x
    dy = py - y
    if r2 is None:
        rr = slab[:, :, None, :, 3]
    else:
        rr = torch.tensor(r2, dtype=torch.float32, device=slab.device)
    P = slab.shape[2]
    live = (torch.arange(P, device=slab.device)
            < count.to(torch.int64)[..., None, None])          # (B, A, 1, P)
    cover = (dx * dx + dy * dy <= rr) & live & (z > znear)
    return torch.where(cover, z, torch.full_like(dx, INF))


def points_select_reference(slab, count, origin, offs, K: int, znear: float,
                            r2=None) -> torch.Tensor:
    """Plain version of the kernel: winner slots (B, A, K, tile^2) int32 of
    the K covering points of lowest z per pixel, ascending in z, ties in
    ascending slot order; -1 where fewer than K points cover."""
    prio = _priority(slab, count, origin, offs, znear, r2)
    z, idx = torch.sort(prio, dim=-1, stable=True)
    z, idx = z[..., :K], idx[..., :K]
    lane = torch.where(z < INF, idx, torch.full_like(idx, -1))
    if lane.shape[-1] < K:
        lane = torch.nn.functional.pad(lane, (0, K - lane.shape[-1]),
                                       value=-1)
    return lane.transpose(2, 3).to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def _check_inputs(slab, count, origin, offs, K: int, r2) -> None:
    if slab.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no point-selection kernel for device {slab.device}")
    need = 4 if r2 is None else 3
    if slab.dtype != torch.float32 or slab.ndim != 4 or slab.shape[-1] < need:
        raise ValueError(f"slab must be float32 (B, A, P, C >= {need}), got "
                         f"{slab.dtype} {tuple(slab.shape)}")
    B, A, P, _ = slab.shape
    if P == 0:
        raise ValueError("slab must hold at least one slot per tile")
    if count.dtype != torch.int32 or tuple(count.shape) != (B, A):
        raise ValueError(f"count must be int32 ({B}, {A}), got {count.dtype} "
                         f"{tuple(count.shape)}")
    if origin.dtype != torch.float32 or tuple(origin.shape) != (B, A, 2):
        raise ValueError(f"origin must be float32 ({B}, {A}, 2), got "
                         f"{origin.dtype} {tuple(origin.shape)}")
    tp = offs.shape[0]
    if (offs.dtype != torch.float32 or offs.ndim != 2 or offs.shape[1] != 2
            or math.isqrt(tp) ** 2 != tp or not 0 < tp <= MAX_TILE ** 2):
        raise ValueError(f"offs must be float32 (tile^2, 2) with tile <= "
                         f"{MAX_TILE}, got {offs.dtype} {tuple(offs.shape)}")
    if not 0 < K <= MAX_K:
        raise ValueError(f"K must be in (0, {MAX_K}]; got {K}")
    if any(t.device != slab.device for t in (count, origin, offs)):
        raise ValueError("slab, count, origin and offs must be on one device")
    if slab.device.type == "cuda" and not all(
            t.is_contiguous() for t in (slab, count, origin, offs)):
        raise ValueError("the CUDA kernel takes contiguous tensors")


def points_select(slab, count, origin, offs, K: int, znear: float,
                  r2=None) -> torch.Tensor:
    """Winner slots (B, A, K, tile^2) int32 of the K covering points of
    lowest z per pixel (-1 = none), ascending in z.

    slab (B, A, P, C) float32: per slot x, y, z and, when r2 is None, the
    point's r^2 in channel 3 (further channels are not read); count (B, A)
    int32 live slots per tile; origin (B, A, 2) raster coords of each
    tile's pixel 0; offs (tile^2, 2) binning.tile_pixel_coords; r2 the
    uniform squared radius, or None for per-point radii."""
    global POINTS_LAUNCHES
    _check_inputs(slab, count, origin, offs, K, r2)
    if slab.device.type == "cpu":
        return points_select_reference(slab, count, origin, offs, K, znear,
                                       r2)
    B, A, P, C = slab.shape
    tp = offs.shape[0]
    lane = torch.empty((B, A, K, tp), dtype=torch.int32,
                       device=slab.device)         # the kernel writes all
    launch("trt_points_select", slab.data_ptr(), count.data_ptr(),
           origin.data_ptr(), offs.data_ptr(), lane.data_ptr(), B, A, P, C,
           K, math.isqrt(tp), 0.0 if r2 is None else r2,
           -1 if r2 is not None else 3, znear, device=slab.device)
    POINTS_LAUNCHES += 1
    return lane


# ---------------------------------------------------------------------------
# The binned rasterization
# ---------------------------------------------------------------------------

def point_budget(max_points_per_bin: int, N: int) -> int:
    """Slots per tile: max_points_per_bin capped at N, stepped up by 32
    when it lands on a multiple of 128 below N, as the JAX package does.
    The step decides which points a full tile drops, so it is part of the
    result."""
    P = min(max_points_per_bin, N)
    if P % 128 == 0 and P < N:
        P = min(P + 32, N)
    return P


class PointInputs(NamedTuple):
    """What a binned point raster hands the kernel, and what maps its
    output back to the image."""

    bins: ActiveBins
    planes: torch.Tensor   # (B, N, 3 | 4) x, y, z [, r^2], differentiable
    slab: torch.Tensor     # (B, A, Pmax, 4 | 5) candidates + point id
    count: torch.Tensor    # (B, A) int32
    table: torch.Tensor    # (B, A, Pmax) int64 point id of each slot
    origin: torch.Tensor   # (B, A, 2) raster coords of each tile's pixel 0
    offs: torch.Tensor     # (tile^2, 2) pixel offsets within a tile
    r2: Optional[float]    # the uniform r^2, or None (per point, channel 3)


def binned_point_inputs(q, z, valid, radius2, settings,
                        uniform_r2=None) -> PointInputs:
    """Check the envelope, bin the points into the tiles of resolved
    settings (bin_size > 0), run the opt-in budget checks and gather the
    kernel's inputs. Points beyond a tile's budget (point_budget) and
    non-empty tiles beyond active_tiles are dropped.

    q (B, N, 2) raster coords, z (B, N), valid (B, N) bool, radius2 (B, N)
    squared NDC radii; uniform_r2 the uniform squared radius (a Python
    float) or None for per-point radii."""
    if settings.impl not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown impl {settings.impl!r}")
    H, W = settings.image_size
    tile = settings.bin_size
    B, N = z.shape
    if tile > MAX_TILE:
        raise ValueError(f"bin_size must be <= {MAX_TILE} (one CUDA thread "
                         f"per tile pixel); got {tile}")
    TH, TW, _ = tile_grid((H, W), tile)
    T = TH * TW
    if B * T * N > 1 << 30:
        raise ValueError(
            f"rank binning envelope B*T*N = {B}x{T}x{N} exceeds 2^30 "
            "elements; raise bin_size (T shrinks quadratically) or reduce "
            "the cloud")
    if N >= 1 << 24:
        raise ValueError(
            f"cloud size N = {N} >= 2^24: point ids ride the slab as float32 "
            "channels (exact only below 2^24); split the cloud")

    r = torch.sqrt(radius2.detach())
    lo = q.detach() - r[..., None]
    hi = q.detach() + r[..., None]
    A = T if settings.active_tiles is None else settings.active_tiles
    bins = bin_ranks_active(lo, hi, valid, (H, W), tile, A)
    if settings.active_tiles is not None:
        check_budget("active_tiles", bins.n_active.max(),
                     settings.active_tiles, settings.check_budgets,
                     hint="size with points.suggest_active_tiles_points")
    Pmax = point_budget(settings.max_points_per_bin, N)
    check_budget("max_points_per_bin", bins.count.max(), Pmax,
                 settings.check_budgets,
                 hint="size with points.suggest_points_per_bin")

    geo = [q[..., 0], q[..., 1], z]
    if uniform_r2 is None:
        geo.append(radius2)
    planes = torch.stack(geo, dim=-1)                         # (B, N, CB)
    slab, count, table = tile_channel_slabs(planes.detach(), bins, Pmax)
    return PointInputs(bins, planes, slab, count, table,
                       bins.origin.contiguous(),
                       tile_pixel_coords((H, W), tile, q.device), uniform_r2)


def rasterize_points_binned_cuda(q, z, valid, radius2, settings, extra=None,
                                 uniform_r2=None) -> PointFragments:
    """Coarse-to-fine top-K point rasterization through the CUDA kernel.

    q, z, valid, radius2, uniform_r2 as binned_point_inputs takes them
    (q, z and radius2 may carry gradients); settings a resolved
    PointsRasterizationSettings (bin_size > 0); extra optional (B, N, CE)
    channels returned per hit."""
    H, W = settings.image_size
    K = settings.points_per_pixel
    tile = settings.bin_size
    B = z.shape[0]
    bins, planes, slab, count, table, origin, offs, r2 = binned_point_inputs(
        q, z, valid, radius2, settings, uniform_r2)
    k_eff = min(K, slab.shape[2])
    lane = points_select(slab, count, origin, offs, k_eff, settings.znear,
                         r2)                                  # (B, A, k, tp)

    # the winners' channels by point id: one differentiable gather
    A_, tp = lane.shape[1], lane.shape[3]
    live = lane >= 0
    pid = table.gather(2, lane.clamp_min(0).long().reshape(B, A_, -1))
    pid = pid.clamp_min(0)              # a tile with no candidate holds -1
    pid = pid.reshape(B, A_, k_eff, tp)
    cols = [planes[..., :3]] + ([] if extra is None else [extra])
    ch = torch.cat(cols, dim=-1)                              # (B, N, 3 + CE)
    C = ch.shape[-1]
    sel = ch.gather(1, pid.reshape(B, -1, 1).expand(-1, -1, C))
    sel = sel.reshape(B, A_, k_eff, tp, C)
    px = (offs[:, 0] + origin[..., 0:1])[:, :, None]          # (B, A, 1, tp)
    py = (offs[:, 1] + origin[..., 1:2])[:, :, None]
    ddx = px - sel[..., 0]
    ddy = py - sel[..., 1]
    d2 = ddx * ddx + ddy * ddy

    def per_hit(v, bg):                  # (B, A, k, tp, ...) -> image
        v = torch.where(live.reshape(live.shape + (1,) * (v.ndim - 4)),
                        v, bg)
        if k_eff < K:                    # clouds smaller than K
            pad = torch.full((B, A_, K - k_eff, tp) + v.shape[4:], bg,
                             dtype=v.dtype, device=v.device)
            v = torch.cat([v, pad], dim=2)
        v = v.transpose(2, 3)                                 # (B, A, tp, K)
        return untile_image(scatter_active_bg(v, bins, bg), (H, W), tile,
                            bins.n_tiles_hw)

    return PointFragments(
        idx=per_hit(pid, -1), zbuf=per_hit(sel[..., 2], -1.0),
        dists2=per_hit(d2, -1.0),
        features=None if extra is None else per_hit(sel[..., 3:], 0.0))

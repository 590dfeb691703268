"""Active-tile rank binning for the soft-silhouette, hard-raster and point
paths (PyTorch counterpart of the binning in
``torch_renderer_tpu.rasterize.binning`` that those paths use).

The image is cut into square pixel tiles. A face is a candidate of every tile
its screen bbox, padded by sqrt(SOFT_CUTOFF * sigma) for the soft path and by
sqrt(blur_radius) for the hard path, overlaps; a point, of every tile its
radius-expanded bbox overlaps. The rules match the JAX package exactly:

  * a tile's candidate slots hold its overlapping faces in ascending face id;
  * faces beyond a tile's ``faces_per_tile`` slots are dropped;
  * non-empty tiles are compacted into ``max_active`` active slots, in
    raster order (order="tile") or by descending candidate count with ties
    in raster order (order="count", the soft path's occupancy split); tiles
    beyond the budget are dropped (coverage 0);
  * unused active slots scatter nowhere.

Every table here is built with cumsum, gather and scatter on fixed-size
buffers (a trash column takes dropped items), so nothing on the render path
waits for the device. The JAX package's one-hot contractions were a TPU gather
workaround and are not carried over. Budgets are Python ints fixed at setup
(the ``suggest_*`` helpers); only those helpers and ``check_budget`` read
device values back.
"""

from __future__ import annotations

import contextlib
import math
import warnings
from typing import NamedTuple, Tuple

import torch

from .cuda_gather import gather_tiles

# Non-overlap sentinel for rank slots (int32 max, as in the JAX package).
NO_SLOT = 2**31 - 1

# ---------------------------------------------------------------------------
# Opt-in budget checks
# ---------------------------------------------------------------------------
#
# Every fixed-size budget here (faces per tile, active tiles, group lanes)
# silently DROPS overflowing work. check_budget() is the opt-in guard: the
# binned path calls it with the true counts it already computed. Mode "warn"
# reads the count back to the host (one device sync) and warns; None is a
# no-op, so the default path never syncs. Inside deferred_budget_checks()
# (a fit's or the bench's loop, whose steps a CUDA graph may replay) "warn"
# keeps each count's running max on the device instead, and the loop reads
# it back once at its end: the counterpart of the JAX package's
# asynchronous jax.debug.callback. Mode "checkify" (the JAX package's
# checkify guard) records the counts the same way inside
# checked_budget_checks() (utils.debug.checked_budgets wraps a call in it)
# and raises BudgetOverflowError at the block's end, naming the budget;
# outside that block it raises at once, as an unwrapped checkify check
# fails in JAX.

BUDGET_CHECK_MODES = (None, "off", "warn", "checkify")
_BUDGET_CHECK_DEFAULT = [None]
_DEFERRED: list = []        # the active BudgetRecords, innermost last
_CHECKED: list = []         # the active checkify BudgetRecords


class BudgetOverflowError(RuntimeError):
    """A budget overflowed under check_budgets="checkify"."""


def set_budget_check_default(mode) -> None:
    """Process-wide default for check_budgets (None | 'off' | 'warn' |
    'checkify'); an explicit per-call value wins. 'off' forces the guards
    off."""
    if mode not in BUDGET_CHECK_MODES:
        raise ValueError(f"unknown budget check mode {mode!r}")
    _BUDGET_CHECK_DEFAULT[0] = mode


def resolve_budget_check(mode):
    mode = _BUDGET_CHECK_DEFAULT[0] if mode is None else mode
    return None if mode == "off" else mode


def _overflow_message(name: str, actual: int, budget: int,
                      hint: str) -> str:
    return (f"{name} overflow: max count {actual} > budget {budget} — "
            f"overflowing work is silently dropped. {hint}").rstrip()


def _overflow_warning(name: str, actual: int, budget: int, hint: str,
                      stacklevel: int) -> None:
    warnings.warn(_overflow_message(name, actual, budget, hint),
                  RuntimeWarning, stacklevel=stacklevel + 1)


class BudgetRecord:
    """The deferred checks of one block: per (budget name, budget, hint),
    the running max of the true count, on the device. The first record of
    a budget is made by an eager step (a captured loop's warm-up); later
    ones, replays included, update it in place."""

    def __init__(self):
        self.max: dict = {}

    def record(self, name: str, actual: torch.Tensor, budget: int,
               hint: str) -> None:
        key = (name, budget, hint)
        seen = self.max.get(key)
        if seen is None:
            self.max[key] = actual.detach().clone()
        else:
            torch.maximum(seen, actual.detach(), out=seen)

    def overflows(self):
        """(name, largest count, budget, hint) of each overflowed budget:
        one host read per budget."""
        for (name, budget, hint), seen in self.max.items():
            a = int(seen)
            if a > budget:
                yield name, a, budget, hint

    def warn(self) -> None:
        """Warn as check_budget does, once per overflowed budget."""
        for name, a, budget, hint in self.overflows():
            _overflow_warning(name, a, budget, hint, stacklevel=3)


@contextlib.contextmanager
def deferred_budget_checks():
    """Defer the "warn" checks made inside to the end of the block: one
    warning per overflowing budget, with its largest count."""
    record = BudgetRecord()
    _DEFERRED.append(record)
    try:
        yield record
    finally:
        _DEFERRED.remove(record)
    record.warn()


@contextlib.contextmanager
def checked_budget_checks():
    """Record the "checkify" checks made inside on the device and, at the
    end of the block, raise BudgetOverflowError naming the first budget
    that overflowed (utils.debug.checked_budgets)."""
    record = BudgetRecord()
    _CHECKED.append(record)
    try:
        yield record
    finally:
        _CHECKED.remove(record)
    for name, a, budget, hint in record.overflows():
        raise BudgetOverflowError(_overflow_message(name, a, budget, hint))


def check_budget(name: str, actual, budget: int, mode, hint: str = "") -> None:
    """Guard a budget: `actual` is the true max count (a scalar tensor or
    int), `budget` the static one. mode None (after the process default)
    is a no-op and touches no device value; "warn" warns when it
    overflows (inside deferred_budget_checks() a tensor count is recorded
    on the device and checked at the block's end); "checkify" records it
    for the enclosing checked_budget_checks() block."""
    mode = resolve_budget_check(mode)
    if mode is None:
        return
    if mode == "checkify":
        if not _CHECKED:
            raise RuntimeError(
                f"{name}: check_budgets='checkify' needs the call wrapped "
                "in utils.debug.checked_budgets")
        _CHECKED[-1].record(name, torch.as_tensor(actual), budget, hint)
        return
    if mode != "warn":
        raise ValueError(f"unknown budget check mode {mode!r}")
    if _DEFERRED and isinstance(actual, torch.Tensor):
        _DEFERRED[-1].record(name, actual, budget, hint)
        return
    a = int(actual)
    if a > budget:
        _overflow_warning(name, a, budget, hint, stacklevel=2)


# ---------------------------------------------------------------------------
# Tile grid and overlap
# ---------------------------------------------------------------------------

def tile_grid(image_size, tile: int, device=None):
    """Static tile decomposition: (TH, TW, tile_origin (T, 2) raster coords
    of each tile's pixel (0, 0) center), tiles in raster order."""
    H, W = image_size
    s = min(H, W) / 2.0
    TH = -(-H // tile)
    TW = -(-W // tile)
    ty = (torch.arange(TH, dtype=torch.float32, device=device) * tile
          + 0.5 - H / 2.0) / s
    tx = (torch.arange(TW, dtype=torch.float32, device=device) * tile
          + 0.5 - W / 2.0) / s
    yy, xx = torch.meshgrid(ty, tx, indexing="ij")
    origin = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)
    return TH, TW, origin


def _bbox_min_max(fp, pad_radius: float):
    """Padded screen bboxes (B, F, 2) from geometry.FacePlanes or
    FaceRasterData (told apart by its corner tensor ``q``)."""
    if hasattr(fp, "q"):
        q = fp.q.detach()
        return q.amin(2) - pad_radius, q.amax(2) + pad_radius
    fminx = torch.minimum(torch.minimum(fp.x0, fp.x1), fp.x2) - pad_radius
    fmaxx = torch.maximum(torch.maximum(fp.x0, fp.x1), fp.x2) + pad_radius
    fminy = torch.minimum(torch.minimum(fp.y0, fp.y1), fp.y2) - pad_radius
    fmaxy = torch.maximum(torch.maximum(fp.y0, fp.y1), fp.y2) + pad_radius
    return (torch.stack([fminx, fminy], -1).detach(),
            torch.stack([fmaxx, fmaxy], -1).detach())


def _overlap(bbox_min, bbox_max, valid, image_size, tile: int):
    """(B, T, F) bool: face f's padded bbox overlaps tile t (and f is
    valid); plus the tile grid."""
    H, W = image_size
    TH, TW, origin = tile_grid(image_size, tile, bbox_min.device)
    t_lo = origin[None, :, None, :]
    t_hi = t_lo + tile / (min(H, W) / 2.0)
    overlap = ((bbox_min[:, None] <= t_hi) & (bbox_max[:, None] >= t_lo)).all(-1)
    return overlap & valid[:, None, :], (TH, TW, origin)


def _face_overlap(fp, image_size, tile: int, pad_radius: float):
    fmin, fmax = _bbox_min_max(fp, pad_radius)
    return _overlap(fmin, fmax, fp.valid, image_size, tile)


def count_overflow(fp, image_size, tile: int, faces_per_tile: int,
                   pad_radius: float):
    """(max candidate count over tiles, number of tiles above
    faces_per_tile), as device scalars (sizing/debug helper)."""
    overlap, _ = _face_overlap(fp, image_size, tile, pad_radius)
    counts = overlap.sum(-1)                                # (B, T)
    return counts.max(), (counts > faces_per_tile).sum()


def count_active_tiles(fp, image_size, tile: int, pad_radius: float):
    """Max over the batch of the non-empty tile count (device scalar)."""
    overlap, _ = _face_overlap(fp, image_size, tile, pad_radius)
    return overlap.any(-1).sum(-1).max()


# ---------------------------------------------------------------------------
# Active-tile rank binning
# ---------------------------------------------------------------------------

class ActiveBins(NamedTuple):
    """Rank bins over compacted non-empty tiles. slot/count are indexed by
    active slot a (not tile t); invrank maps a back to its tile id (T + 1 for
    unused slots); origin is the active tile's raster origin (0 if unused)."""

    slot: torch.Tensor         # (B, A, F) int64: rank of face f, or NO_SLOT
    count: torch.Tensor        # (B, A) int64 candidates (uncapped)
    invrank: torch.Tensor      # (B, A) int64
    rank: torch.Tensor         # (B, T) int64 active index of tile t (>= A: none)
    origin: torch.Tensor       # (B, A, 2) float32
    n_active: torch.Tensor     # (B,) int64 true non-empty count (diagnostics)
    tile_origin: torch.Tensor  # (T, 2)
    n_tiles_hw: Tuple[int, int]


def bin_ranks_active(bbox_min, bbox_max, valid, image_size, tile: int,
                     max_active: int, order: str = "tile") -> ActiveBins:
    """Rank-binning with the tile axis compacted to the non-empty tiles.

    order: "tile" ranks them in raster order; "count" by descending
    candidate count, ties in raster order (a stable sort of the negated
    count: the JAX package's (B, T, T) comparison gives the same ranks).
    Slots at or beyond max_active are dropped either way; scatter_active
    puts every kept tile back in its raster place."""
    overlap, (TH, TW, origin) = _overlap(bbox_min, bbox_max, valid,
                                         image_size, tile)
    B, T, F = overlap.shape
    A = min(max_active, T)
    device = overlap.device

    nonempty = overlap.any(-1)                              # (B, T)
    if order == "count":
        # empty tiles key +1, after every non-empty one
        key = torch.where(nonempty, -overlap.sum(-1), 1)
        trank = torch.argsort(torch.sort(key, dim=-1, stable=True).indices,
                              dim=-1)
    elif order == "tile":
        trank = torch.cumsum(nonempty.long(), dim=-1) - 1
    else:
        raise ValueError(f"unknown active-tile order: {order!r}")
    rank = torch.where(nonempty, trank, torch.full_like(trank, A + 1))

    # invrank: tile id per active slot, through a trash column A for every
    # tile that has no slot (empty, or beyond the budget)
    dest = rank.clamp(max=A)
    tiles = torch.arange(T, device=device).expand(B, T)
    inv = torch.full((B, A + 1), T + 1, dtype=torch.int64, device=device)
    invrank = inv.scatter(1, dest, tiles)[:, :A]

    # rows T and T + 1 of the padded tables are what unused slots read
    overlap_p = torch.cat(
        [overlap, overlap.new_zeros((B, 2, F))], dim=1)     # (B, T + 2, F)
    overlap_c = overlap_p.gather(1, invrank[..., None].expand(B, A, F))
    rankf = torch.cumsum(overlap_c.long(), dim=-1)          # 1-based
    slot = torch.where(overlap_c, rankf - 1, torch.full_like(rankf, NO_SLOT))

    origin_p = torch.cat([origin, origin.new_zeros((2, 2))], dim=0)
    return ActiveBins(
        slot=slot, count=rankf[..., -1], invrank=invrank, rank=rank,
        origin=origin_p[invrank], n_active=nonempty.sum(-1),
        tile_origin=origin, n_tiles_hw=(TH, TW),
    )


def bin_faces_active(fp, image_size, tile: int, pad_radius: float,
                     max_active: int, order: str = "tile") -> ActiveBins:
    """Active-tile rank-binning of faces by padded screen bbox."""
    fmin, fmax = _bbox_min_max(fp, pad_radius)
    return bin_ranks_active(fmin, fmax, fp.valid, image_size, tile,
                            max_active, order=order)


def split_bins(bins: ActiveBins, hi_tiles: int, k_lo: int) -> ActiveBins:
    """The occupancy split on count-ordered bins: the ranks from hi_tiles
    on keep their lowest-id k_lo candidates (slots at or beyond k_lo are
    emptied and their counts capped), as the JAX package's tail gather of
    k_lo slots keeps them. The soft and hard kernels read min(count, slots)
    per tile, so the split needs no kernel of its own."""
    tail = torch.arange(bins.count.shape[1],
                        device=bins.count.device) >= hi_tiles      # (A,)
    return bins._replace(
        slot=torch.where(tail[:, None] & (bins.slot >= k_lo), NO_SLOT,
                         bins.slot),
        count=torch.where(tail, bins.count.clamp(max=k_lo), bins.count))


def slot_faces(bins: ActiveBins, per_tile: int,
               empty: int = 0) -> torch.Tensor:
    """(B, A, per_tile) contiguous face id held by each candidate slot.
    Slots at or beyond a tile's capped count hold ``empty`` (0 keeps them in
    bounds, never read as a candidate; -1 marks them for
    cuda_gather.gather_tiles); faces ranked beyond per_tile land in a trash
    column."""
    B, A, F = bins.slot.shape
    dest = bins.slot.clamp(max=per_tile)
    faces = torch.arange(F, device=dest.device).expand(B, A, F)
    table = torch.full((B, A, per_tile + 1), empty, dtype=torch.int64,
                       device=dest.device)
    return table.scatter(2, dest, faces)[..., :per_tile].contiguous()


def scatter_active(values: torch.Tensor, bins: ActiveBins) -> torch.Tensor:
    """(B, A, P) active-slot values -> (B, T, P) full tile grid; tiles with
    no active slot receive exactly 0."""
    return scatter_active_bg(values, bins, 0.0)


def scatter_active_bg(values: torch.Tensor, bins: ActiveBins,
                      bg) -> torch.Tensor:
    """(B, A, ...) active-slot values -> (B, T, ...) full tile grid; tiles
    with no active slot (empty, or beyond the budget) receive ``bg``, a
    scalar or a tensor broadcastable to the trailing dims. A gather through
    the tile rank from the values plus one background row, so every output
    is an exact copy and its backward has one source per element."""
    return gather_rows_bg(values, bins.rank, bg)


def gather_rows_bg(values: torch.Tensor, slot: torch.Tensor,
                   bg) -> torch.Tensor:
    """(B, A, ...) rows -> (B, T, ...): row slot[b, t] of values, or ``bg``
    where slot[b, t] (>= 0) is A or more (scatter_active_bg through any
    per-tile slot table)."""
    B, A = values.shape[:2]
    trail = tuple(values.shape[2:])
    if isinstance(bg, torch.Tensor):
        bg_row = bg.to(values.dtype).expand((B, 1) + trail)
    else:   # a fill: no host-to-device copy
        bg_row = values.new_full((B, 1) + trail, bg)
    padded = torch.cat([values, bg_row], dim=1)
    idx = slot.long().clamp(max=A)                            # (B, T)
    T = idx.shape[1]
    idx = idx.reshape((B, T) + (1,) * len(trail)).expand((B, T) + trail)
    return padded.gather(1, idx)


def face_channel_planes(fd, znear: float = 1e-5) -> torch.Tensor:
    """(B, F, 12) per-face channels of the hard raster, in slab order
    qx0 qy0 qx1 qy1 qx2 qy2 z0 z1 z2 invz0 invz1 invz2, from FacePlanes
    (invz = 1/clip(z, znear), znear fixed at its default as in the JAX
    package's channel sources) or FaceRasterData (its own invz)."""
    if hasattr(fd, "q"):
        return torch.cat([fd.q.flatten(2), fd.z, fd.invz], dim=-1)
    z = torch.stack([fd.z0, fd.z1, fd.z2], dim=-1)
    return torch.cat([
        torch.stack([fd.x0, fd.y0, fd.x1, fd.y1, fd.x2, fd.y2], dim=-1),
        z, 1.0 / z.clamp_min(znear)], dim=-1)


def tile_channel_slabs(planes: torch.Tensor, bins: ActiveBins,
                       per_tile: int):
    """The binned kernels' inputs, gathered from (B, N, C) per-item
    channels (the hard path's 12 face channels, the point path's x, y, z
    and r^2) by the tile-gather kernel (cuda_gather.gather_tiles):

    slab (B, A, per_tile, C + 1) float32: each active tile's candidates in
        ascending item id, the C channels plus the global item id (exact
        in float32 below 2^24 items); slots beyond the count are 0;
    count (B, A) int32: candidates per tile, capped at per_tile (items
        beyond it are dropped);
    table (B, A, per_tile) int64: the item id of each slot, -1 at slots
        beyond the count (a caller that indexes with it clamps)."""
    table = slot_faces(bins, per_tile, empty=-1)
    B, N = planes.shape[:2]
    fid = torch.arange(N, dtype=planes.dtype, device=planes.device)
    ch = torch.cat([planes, fid.expand(B, N)[..., None]], dim=-1)
    count = bins.count.clamp(max=per_tile).to(torch.int32)
    return gather_tiles(table, ch), count, table


def tile_pixel_coords(image_size, tile: int, device=None) -> torch.Tensor:
    """Local pixel offsets within a tile, raster units: (tile^2, 2) x, y in
    row-major pixel order (added to a tile's origin)."""
    H, W = image_size
    d = torch.arange(tile, dtype=torch.float32, device=device) / (
        min(H, W) / 2.0)
    yy, xx = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)


def untile_image(per_tile: torch.Tensor, image_size, tile: int, n_tiles_hw):
    """(B, T, tile*tile, C?) -> (B, H, W, C?) cropping any right/bottom pad."""
    TH, TW = n_tiles_hw
    B = per_tile.shape[0]
    trailing = tuple(per_tile.shape[3:])
    img = per_tile.reshape((B, TH, TW, tile, tile) + trailing)
    img = img.movedim(3, 2).reshape((B, TH * tile, TW * tile) + trailing)
    H, W = image_size
    return img[:, :H, :W]


# ---------------------------------------------------------------------------
# Budget sizing (setup-time; these read device values back)
# ---------------------------------------------------------------------------

_GROUP = 8  # tiles per pack group of the JAX packed layout


def group_counts(capped: torch.Tensor) -> torch.Tensor:
    """(B, ceil(A/8)) candidates per group of 8 active tiles from each
    tile's capped count (B, A): what the JAX packed layout's group_lanes
    must hold."""
    B, A = capped.shape
    capped = torch.cat([capped, capped.new_zeros((B, (-A) % _GROUP))], dim=1)
    return capped.reshape(B, -1, _GROUP).sum(-1)


def _bbox_tile_counts(bbox_min, bbox_max, valid, image_size, tile: int,
                      chunk: int = 8192) -> torch.Tensor:
    """(B, T) overlapping items per tile, summed over chunks of the item
    axis so a large cloud never builds a (B, T, N) table."""
    counts = None
    for n0 in range(0, valid.shape[-1], chunk):
        ov, _ = _overlap(bbox_min[:, n0:n0 + chunk],
                         bbox_max[:, n0:n0 + chunk],
                         valid[:, n0:n0 + chunk], image_size, tile)
        c = ov.sum(-1)
        counts = c if counts is None else counts + c
    return counts


def count_bbox_overflow(bbox_min, bbox_max, valid, image_size,
                        tile: int) -> int:
    """Max candidate count over tiles for bbox binning (sizing helper for
    the point budget; reads the count back to the host)."""
    return int(_bbox_tile_counts(bbox_min, bbox_max, valid, image_size,
                                 tile).max())


def count_bbox_active_tiles(bbox_min, bbox_max, valid, image_size,
                            tile: int) -> int:
    """Max over the batch of the non-empty tile count for bbox binning
    (sizing helper for active_tiles; reads it back to the host)."""
    counts = _bbox_tile_counts(bbox_min, bbox_max, valid, image_size, tile)
    return int((counts > 0).sum(-1).max())


def suggest_active_tiles_fd(fp, image_size, tile: int, pad_radius: float,
                            margin: float = 1.3) -> int:
    """Smallest safe active-tile budget for this scene (max non-empty tile
    count over the batch, with headroom, a multiple of 8 as in the JAX
    package); tiles beyond it are dropped."""
    n = int(count_active_tiles(fp, image_size, tile, pad_radius))
    TH, TW, _ = tile_grid(image_size, tile)
    want = int(math.ceil(n * margin / _GROUP)) * _GROUP
    return max(_GROUP, min(want, TH * TW))


def suggest_group_lanes_fd(fp, image_size, tile: int, pad_radius: float,
                           max_active: int, faces_per_tile: int,
                           margin: float = 1.3, order: str = "tile") -> int:
    """The JAX packed layout's lane budget per group of 8 active tiles (max
    summed capped count, with headroom, a multiple of 128). The port's kernel
    drops nothing for it; it is sized so both packages agree. Pass
    order="count" with the occupancy split, whose count-ordered tiles group
    otherwise."""
    bins = bin_faces_active(fp, image_size, tile, pad_radius, max_active,
                            order=order)
    n = int(group_counts(bins.count.clamp(max=faces_per_tile)).max())
    want = int(math.ceil(n * margin / 128)) * 128
    return max(128, min(want, _GROUP * faces_per_tile))


def suggest_occupancy_split_fd(fp, image_size, tile: int, pad_radius: float,
                               max_active: int, max_faces_per_bin: int,
                               lo_candidates=(16, 32, 48, 64, 96),
                               margin: float = 1.3, multiple: int = 8):
    """(hi_tiles, lo_lanes) for RasterizationSettings.occupancy_split, or
    None when no candidate improves on the single budget (the JAX package's
    sizing rule, so both packages size the same split).

    For each candidate lo, tiles whose margined count exceeds lo need the
    full max_faces_per_bin budget; the modeled work hi * full + (A - hi) *
    lo is minimized over the candidates, on the counts of the count-ordered
    active slots (unused slots count 0)."""
    bins = bin_faces_active(fp, image_size, tile, pad_radius, max_active,
                            order="count")
    cnt = bins.count.cpu().numpy()                          # (B, A)
    A = cnt.shape[1]
    full = min(max_faces_per_bin, int(fp.valid.shape[-1]))
    best, best_work = None, None
    for lo in lo_candidates:
        if lo >= full:
            continue
        n_hi = int((cnt * margin > lo).sum(axis=1).max())
        hi = min(A, int(math.ceil(max(n_hi, 1) * margin / multiple))
                 * multiple)
        if hi >= A:
            continue
        work = hi * full + (A - hi) * lo
        if best_work is None or work < best_work:
            best, best_work = (hi, lo), work
    if best is None or best_work > 0.9 * A * full:  # no real modeled win
        return None
    return best

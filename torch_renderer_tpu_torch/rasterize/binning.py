"""Active-tile rank binning for the soft-silhouette, hard-raster and point
paths (PyTorch counterpart of the binning in
``torch_renderer_tpu.rasterize.binning`` that those paths use).

The image is cut into square pixel tiles. A face is a candidate of every tile
its screen bbox, padded by sqrt(SOFT_CUTOFF * sigma) for the soft path and by
sqrt(blur_radius) for the hard path, overlaps; a point, of every tile its
radius-expanded bbox overlaps. The rules match the JAX package exactly:

  * a tile's candidate slots hold its overlapping faces in ascending face id;
  * faces beyond a tile's ``faces_per_tile`` slots are dropped;
  * non-empty tiles are compacted in raster order into ``max_active`` active
    slots; tiles beyond the budget are dropped (coverage 0);
  * unused active slots scatter nowhere.

Every table here is built with cumsum, gather and scatter on fixed-size
buffers (a trash column takes dropped items), so nothing on the render path
waits for the device. The JAX package's one-hot contractions were a TPU gather
workaround and are not carried over. Budgets are Python ints fixed at setup
(the ``suggest_*`` helpers); only those helpers and ``check_budget`` read
device values back.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple, Tuple

import torch

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
# no-op, so the default path never syncs.

_BUDGET_CHECK_DEFAULT = [None]


def set_budget_check_default(mode) -> None:
    """Process-wide default for check_budgets (None | 'off' | 'warn'); an
    explicit per-call value wins. 'off' forces the guards off."""
    if mode not in (None, "off", "warn"):
        raise ValueError(f"unknown budget check mode {mode!r}")
    _BUDGET_CHECK_DEFAULT[0] = mode


def resolve_budget_check(mode):
    mode = _BUDGET_CHECK_DEFAULT[0] if mode is None else mode
    return None if mode == "off" else mode


def check_budget(name: str, actual, budget: int, mode, hint: str = "") -> None:
    """Warn when `actual` (the true max count, a scalar tensor or int)
    exceeds the static `budget`. mode None (after the process default) is a
    no-op and touches no device value."""
    mode = resolve_budget_check(mode)
    if mode is None:
        return
    if mode != "warn":
        raise ValueError(f"unknown budget check mode {mode!r}")
    a = int(actual)
    if a > budget:
        warnings.warn(
            f"{name} overflow: max count {a} > budget {budget} — overflowing "
            f"work is silently dropped. {hint}".rstrip(),
            RuntimeWarning, stacklevel=2,
        )


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
                     max_active: int) -> ActiveBins:
    """Rank-binning with the tile axis compacted to the non-empty tiles, in
    raster order (the JAX package's order="tile")."""
    overlap, (TH, TW, origin) = _overlap(bbox_min, bbox_max, valid,
                                         image_size, tile)
    B, T, F = overlap.shape
    A = min(max_active, T)
    device = overlap.device

    nonempty = overlap.any(-1)                              # (B, T)
    trank = torch.cumsum(nonempty.long(), dim=-1) - 1
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
                     max_active: int) -> ActiveBins:
    """Active-tile rank-binning of faces by padded screen bbox."""
    fmin, fmax = _bbox_min_max(fp, pad_radius)
    return bin_ranks_active(fmin, fmax, fp.valid, image_size, tile,
                            max_active)


def slot_faces(bins: ActiveBins, per_tile: int) -> torch.Tensor:
    """(B, A, per_tile) face id held by each candidate slot. Slots at or
    beyond a tile's capped count hold face 0 (in bounds, never read as a
    candidate); faces ranked beyond per_tile land in a trash column."""
    B, A, F = bins.slot.shape
    dest = bins.slot.clamp(max=per_tile)
    faces = torch.arange(F, device=dest.device).expand(B, A, F)
    table = torch.zeros((B, A, per_tile + 1), dtype=torch.int64,
                        device=dest.device)
    return table.scatter(2, dest, faces)[..., :per_tile]


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
    B, A = values.shape[:2]
    trail = tuple(values.shape[2:])
    bg_row = torch.as_tensor(bg, dtype=values.dtype, device=values.device)
    padded = torch.cat([values, bg_row.expand((B, 1) + trail)], dim=1)
    idx = bins.rank.clamp(max=A)                            # (B, T)
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
    and r^2):

    slab (B, A, per_tile, C + 1) float32: each active tile's candidates in
        ascending item id, the C channels plus the global item id (exact
        in float32 below 2^24 items);
    count (B, A) int32: candidates per tile, capped at per_tile (items
        beyond it are dropped);
    table (B, A, per_tile) int64: the item id of each slot (0 at slots
        beyond the count, which are never read)."""
    table = slot_faces(bins, per_tile)
    B, A, K = table.shape
    N, C = planes.shape[1], planes.shape[2] + 1
    fid = torch.arange(N, dtype=planes.dtype, device=planes.device)
    ch = torch.cat([planes, fid.expand(B, N)[..., None]], dim=-1)
    slab = ch.gather(1, table.reshape(B, A * K, 1).expand(B, A * K, C))
    count = bins.count.clamp(max=per_tile).to(torch.int32)
    return slab.reshape(B, A, K, C), count, table


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


def group_counts(bins: ActiveBins, per_tile: int) -> torch.Tensor:
    """(B, ceil(A/8)) candidates per group of 8 active tiles, each tile
    capped at per_tile: what the JAX packed layout's group_lanes must hold."""
    capped = bins.count.clamp(max=per_tile)                 # (B, A)
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
                           margin: float = 1.3) -> int:
    """The JAX packed layout's lane budget per group of 8 active tiles (max
    summed capped count, with headroom, a multiple of 128). The port's kernel
    drops nothing for it; it is sized so both packages agree."""
    bins = bin_faces_active(fp, image_size, tile, pad_radius, max_active)
    n = int(group_counts(bins, faces_per_tile).max())
    want = int(math.ceil(n * margin / 128)) * 128
    return max(128, min(want, _GROUP * faces_per_tile))

"""Tile-binned soft-silhouette coverage through hand-written CUDA kernels
(PyTorch counterpart of ``torch_renderer_tpu.rasterize.pallas_soft``).

The path: bin faces into active tiles (binning.bin_faces_active), gather
each tile's candidate corners into (B, A, K, 6) slabs with the tile-gather
kernel pair (cuda_gather) and translate them into the tile's own pixel
frame, run the coverage kernel pair, scatter the per-tile sums back to the
tile grid and untile into the image.

Per (pixel p, face f): signed d2 = +min_e dist2(p, edge_e) outside and
-min_e inside; S(p) = sum_f softplus(-d2 / sigma); alpha = 1 - exp(-S).
Gradients flow through the squared point-to-edge distances only: the inside
test and the clamped foot parameter t are not differentiated, and edges
tied at the minimum share the gradient evenly (1, 1/2 or 1/3), as the JAX
package's hand-derived backward does. Translating corners by the tile origin
keeps the float32 arithmetic on small numbers and does not change the
gradient with respect to the corners.

All three of the JAX package's layouts ("lane", "packed", "sublane") run
the one kernel pair here, and so does the packed layout's occupancy split
(hi_tiles): it ranks the active tiles by candidate count and caps the
tail's slots, which the kernels read as a shorter count. For every kernel
the module keeps its plain PyTorch version (``soft_coverage_fwd_reference``,
``soft_coverage_bwd_reference``): a wrapper uses it for a tensor on the
CPU, launches the kernel for a CUDA tensor, and raises for anything else.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .._build import launch
from .binning import (
    NO_SLOT,
    ActiveBins,
    bin_faces_active,
    check_budget,
    count_overflow,
    group_counts,
    resolve_budget_check,
    scatter_active,
    slot_faces,
    suggest_active_tiles_fd,
    suggest_group_lanes_fd,
    untile_image,
)
from .cuda_gather import gather_tiles
from .geometry import FacePlanes, setup_face_planes
from .soft import SOFT_CUTOFF

# Kernel launches since import (or since a caller reset them): one per
# launched kernel, counted where the wrapper launches it and nowhere else.
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

_MAX_TILE_PIXELS = 1024   # the forward runs one thread per pixel of a tile


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the kernels
# ---------------------------------------------------------------------------

def _pixel_offsets(tile: int, inv_s: float, device):
    """Within-tile pixel offsets (tile^2,), raster units, row-major."""
    idx = torch.arange(tile * tile, device=device)
    return ((idx % tile).to(torch.float32) * inv_s,
            (idx // tile).to(torch.float32) * inv_s)


def _edge_terms(px, py, qxa, qya, qxb, qyb):
    """Clamped squared distance to segment (a, b) and its helpers."""
    gx = qxb - qxa
    gy = qyb - qya
    len2 = (gx * gx + gy * gy).clamp_min(1e-12)
    inv_len2 = 1.0 / len2                    # per face, not per pair
    wx = px - qxa
    wy = py - qya
    wg = wx * gx + wy * gy
    t = (wg * inv_len2).clamp(0.0, 1.0)
    dd = wx * wx + wy * wy - 2.0 * t * wg + t * t * len2
    return dd.clamp_min(0.0), t, wx, wy, gx, gy


def _pair_terms(q, count, tile: int, inv_s: float):
    """Everything both passes need per (B, A, pixel, slot) pair."""
    xoff, yoff = _pixel_offsets(tile, inv_s, q.device)
    px, py = xoff[:, None], yoff[:, None]                  # (P, 1)
    qc = [q[..., None, :, c] for c in range(6)]            # (B, A, 1, K)
    edges = [_edge_terms(px, py, qc[2 * a], qc[2 * a + 1],
                         qc[2 * b], qc[2 * b + 1])
             for a, b in ((0, 1), (1, 2), (2, 0))]
    d2 = torch.minimum(torch.minimum(edges[0][0], edges[1][0]), edges[2][0])
    area2 = ((qc[2] - qc[0]) * (qc[5] - qc[1])
             - (qc[3] - qc[1]) * (qc[4] - qc[0]))
    inside = None
    for _, _, wx, wy, gx, gy in edges:
        in_e = (gx * wy - gy * wx) * area2 >= 0.0
        inside = in_e if inside is None else inside & in_e
    K = q.shape[2]
    live = (torch.arange(K, device=q.device) < count[..., None])[..., None, :]
    signed = torch.where(inside, -d2, d2)
    signed = torch.where(live, signed, torch.full_like(signed, 1e9))
    return signed, d2, inside, live, edges


def soft_coverage_fwd_reference(q, count, tile: int, inv_s: float,
                                inv_sigma: float) -> torch.Tensor:
    """Plain version of the forward kernel: q (B, A, K, 6) tile-frame
    corners, count (B, A) -> S (B, A, tile^2)."""
    signed, *_ = _pair_terms(q, count, tile, inv_s)
    x = -signed * inv_sigma
    # stable softplus: inside pixels reach x ~ 1e3, where exp overflows
    return (x.clamp_min(0.0) + torch.log1p(torch.exp(-x.abs()))).sum(-1)


def soft_coverage_bwd_reference(q, count, g, tile: int, inv_s: float,
                                inv_sigma: float) -> torch.Tensor:
    """Plain version of the backward kernel: dS/dq (B, A, K, 6) for the
    cotangent g (B, A, tile^2). Written out by hand: autograd through
    nested minimums would split a three-way tie 1/2, 1/4, 1/4 instead of
    evenly."""
    signed, d2, inside, live, edges = _pair_terms(q, count, tile, inv_s)
    sgn = torch.where(inside, -1.0, 1.0)
    alpha = g[..., None] * torch.sigmoid(-signed * inv_sigma) * (-inv_sigma) * sgn
    alpha = torch.where(live, alpha, torch.zeros_like(alpha))
    m = [(e[0] <= d2).to(torch.float32) for e in edges]
    norm = m[0] + m[1] + m[2]
    an = alpha * torch.where(norm <= 1.0, 1.0,
                             torch.where(norm <= 2.0, 0.5, 1.0 / 3.0))
    dq = [0.0] * 6
    for (a, b), (_, t, wx, wy, gx, gy), m_e in zip(((0, 1), (1, 2), (2, 0)),
                                                   edges, m):
        # dd = |w - t g|^2 with t held fixed:
        #   d(dd)/d(a) = -2(1-t)(w - t g),  d(dd)/d(b) = -2t(w - t g)
        b2 = 2.0 * an * m_e
        ca, cg = b2 * (t - 1.0), b2 * t * (1.0 - t)
        cbw, cbg = -b2 * t, b2 * t * t
        dq[2 * a] = dq[2 * a] + (ca * wx + cg * gx).sum(-2)
        dq[2 * a + 1] = dq[2 * a + 1] + (ca * wy + cg * gy).sum(-2)
        dq[2 * b] = dq[2 * b] + (cbw * wx + cbg * gx).sum(-2)
        dq[2 * b + 1] = dq[2 * b + 1] + (cbw * wy + cbg * gy).sum(-2)
    return torch.stack(dq, dim=-1)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_inputs(q, count, tile: int, g=None):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no soft-coverage kernel for device {q.device}")
    if q.dtype != torch.float32 or q.ndim != 4 or q.shape[-1] != 6:
        raise ValueError(f"q must be float32 (B, A, K, 6), got {q.dtype} "
                         f"{tuple(q.shape)}")
    B, A, _, _ = q.shape
    if count.dtype != torch.int32 or tuple(count.shape) != (B, A):
        raise ValueError(f"count must be int32 ({B}, {A}), got {count.dtype} "
                         f"{tuple(count.shape)}")
    if not 0 < tile * tile <= _MAX_TILE_PIXELS:
        raise ValueError(f"tile^2 must be in (0, {_MAX_TILE_PIXELS}]; "
                         f"got tile={tile}")
    if g is not None and (g.dtype != torch.float32
                          or tuple(g.shape) != (B, A, tile * tile)):
        raise ValueError(f"g must be float32 ({B}, {A}, {tile * tile}), got "
                         f"{g.dtype} {tuple(g.shape)}")
    tensors = (q, count) if g is None else (q, count, g)
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, count and g must be on one device")
    if q.device.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernels take contiguous tensors")


def soft_coverage_fwd(q, count, tile: int, inv_s: float,
                      inv_sigma: float) -> torch.Tensor:
    """S (B, A, tile^2) = per-pixel coverage sums of each active tile's
    first count[b, a] candidate slots of q (B, A, K, 6)."""
    global FWD_LAUNCHES
    _check_inputs(q, count, tile)
    if q.device.type == "cpu":
        return soft_coverage_fwd_reference(q, count, tile, inv_s, inv_sigma)
    B, A, K, _ = q.shape
    if B * A * K == 0:
        return q.new_zeros((B, A, tile * tile))
    S = q.new_empty((B, A, tile * tile))      # the kernel writes every pixel
    launch("trt_soft_coverage_fwd", q.data_ptr(), count.data_ptr(),
            S.data_ptr(), B, A, K, tile, inv_s, inv_sigma, device=q.device)
    FWD_LAUNCHES += 1
    return S


def soft_coverage_bwd(q, count, g, tile: int, inv_s: float,
                      inv_sigma: float) -> torch.Tensor:
    """dS/dq (B, A, K, 6) contracted with the cotangent g (B, A, tile^2);
    zero at slots beyond count."""
    global BWD_LAUNCHES
    _check_inputs(q, count, tile, g)
    if q.device.type == "cpu":
        return soft_coverage_bwd_reference(q, count, g, tile, inv_s,
                                           inv_sigma)
    if q.numel() == 0:
        return torch.zeros_like(q)
    B, A, K, _ = q.shape
    dq = torch.empty_like(q)                  # the kernel writes every slot
    launch("trt_soft_coverage_bwd", q.data_ptr(), count.data_ptr(),
            g.data_ptr(), dq.data_ptr(), B, A, K, tile, inv_s, inv_sigma,
            device=q.device)
    BWD_LAUNCHES += 1
    return dq


class SoftCoverage(torch.autograd.Function):
    """The kernel pair as one differentiable op: q -> S, gradient to q."""

    @staticmethod
    def forward(ctx, q, count, tile, inv_s, inv_sigma):
        ctx.save_for_backward(q, count)
        ctx.params = (tile, inv_s, inv_sigma)
        return soft_coverage_fwd(q, count, tile, inv_s, inv_sigma)

    @staticmethod
    def backward(ctx, g):
        q, count = ctx.saved_tensors
        dq = soft_coverage_bwd(q, count, g.contiguous(), *ctx.params)
        return dq, None, None, None, None


# ---------------------------------------------------------------------------
# Public surface
# ---------------------------------------------------------------------------

def tile_slabs(fp: FacePlanes, bins: ActiveBins, per_tile: int):
    """The kernels' inputs: q (B, A, per_tile, 6), each active tile's
    candidate corners in the tile's own pixel frame, gathered by the
    tile-gather kernel pair (differentiable with respect to fp; slots
    beyond the count hold 0 before the translation and are never read),
    and count (B, A) int32, its candidates capped at per_tile."""
    idx = slot_faces(bins, per_tile, empty=-1)
    planes = torch.stack([fp.x0, fp.y0, fp.x1, fp.y1, fp.x2, fp.y2], dim=-1)
    q = gather_tiles(idx, planes)
    return (q - bins.origin.repeat(1, 1, 3)[:, :, None, :],
            bins.count.clamp(max=per_tile).to(torch.int32))


def _split_bins(bins: ActiveBins, hi_tiles: int, k_lo: int) -> ActiveBins:
    """The packed layout's occupancy split on count-ordered bins: the ranks
    from hi_tiles on keep their lowest-id k_lo candidates (slots at or
    beyond k_lo are emptied and their counts capped), as the JAX package's
    tail gather of k_lo slots keeps them. The kernels read min(count,
    slots) per tile, so the split needs no kernel of its own."""
    tail = torch.arange(bins.count.shape[1],
                        device=bins.count.device) >= hi_tiles      # (A,)
    return bins._replace(
        slot=torch.where(tail[:, None] & (bins.slot >= k_lo), NO_SLOT,
                         bins.slot),
        count=torch.where(tail, bins.count.clamp(max=k_lo), bins.count))


def _budget_checks(bins: ActiveBins, A: int | None, K: int, layout: str,
                   group_lanes: int | None, split, mode) -> None:
    """The opt-in overflow guards; each reads one count back to the host.
    split: None or (hi_tiles, k_lo) of the occupancy split."""
    if resolve_budget_check(mode) is None:
        return
    if A is not None:
        check_budget("active_tiles", bins.n_active.max(), A, mode,
                     hint="size with suggest_active_tiles")
    check_budget("faces_per_tile", bins.count.max(), K, mode,
                 hint="size with suggest_faces_per_tile")
    if split is not None:
        hi_tiles, k_lo = split
        check_budget("occupancy_split lo_lanes",
                     bins.count[:, hi_tiles:].max(), k_lo, mode,
                     hint="size with suggest_occupancy_split")
        bins = _split_bins(bins, hi_tiles, k_lo)
    if layout == "packed":
        S_g = 8 * K if group_lanes is None else group_lanes
        S_g += (-S_g) % 128
        check_budget("group_lanes",
                     group_counts(bins.count.clamp(max=K)).max(), S_g, mode,
                     hint="size with suggest_group_lanes")


def soft_silhouette_fd(
    fp: FacePlanes,
    image_size,
    sigma: float = 1e-4,
    tile: int = 16,
    faces_per_tile: int = 128,
    return_sum: bool = False,
    layout: str = "lane",
    active_tiles: int | None = None,
    group_lanes: int | None = None,
    hi_tiles: int | None = None,
    lo_lanes: int = 32,
    check_budgets: str | None = None,
) -> torch.Tensor:
    """Tile-binned soft coverage (B, H, W) (or the sum S with return_sum)
    through the CUDA kernel pair; the counterpart of
    ``soft_silhouette_pallas_fd``.

    Exact (the streaming oracle's sum) as long as no budget overflows:
    faces beyond ``faces_per_tile`` in a tile and non-empty tiles beyond
    ``active_tiles`` are dropped; size both with suggest_soft_config().
    ``active_tiles=None`` gives every tile a slot, so none is dropped.

    layout: "lane", "packed" and "sublane" all run the one kernel pair.
    "packed" requires active_tiles, as in the JAX package. ``group_lanes``
    is the JAX packed layout's per-group lane budget: it is checked by
    check_budgets but drops nothing here. "sublane" computes what the JAX
    package's sublane layout computes: every tile binned (active_tiles,
    group_lanes, hi_tiles and check_budgets are not read) with the face
    budget rounded up to a multiple of 8.

    hi_tiles, lo_lanes: the packed layout's occupancy split ("lane" and
    "sublane" ignore it, as in the JAX package). With hi_tiles > 0 the
    active tiles are ranked by descending candidate count; the first
    hi_tiles keep faces_per_tile slots and the rest min(lo_lanes,
    faces_per_tile), dropping their higher-id candidates beyond it. Size
    it with suggest_occupancy_split(); hi_tiles must be a multiple of 8
    below the active-tile count.
    """
    if layout not in ("lane", "packed", "sublane"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "packed" and active_tiles is None:
        raise ValueError(
            "layout='packed' requires active_tiles (the pack groups follow "
            "active-compaction order); size it with suggest_active_tiles()")

    H, W = image_size
    T = (-(-H // tile)) * (-(-W // tile))
    K = min(faces_per_tile, fp.num_faces)
    if layout == "sublane":
        K += (-K) % 8            # the JAX sublane kernels' 8-face granule
        active_tiles = None
    split = None              # or (hi_tiles, the tail's slots)
    if layout == "packed" and hi_tiles is not None and hi_tiles > 0:
        split = (hi_tiles, min(lo_lanes, K))
    pad = math.sqrt(SOFT_CUTOFF * sigma)
    bins = bin_faces_active(fp, image_size, tile, pad,
                            T if active_tiles is None else active_tiles,
                            order="tile" if split is None else "count")
    A = bins.count.shape[1]
    if split is not None and (hi_tiles % 8 or hi_tiles >= A):
        raise ValueError(
            f"hi_tiles must be a multiple of 8 and < active tiles ({A}); "
            f"got {hi_tiles}")
    if layout != "sublane":
        _budget_checks(bins, active_tiles, K, layout, group_lanes, split,
                       check_budgets)
    if split is not None:
        bins = _split_bins(bins, *split)

    q, count = tile_slabs(fp, bins, K)
    inv_s = 1.0 / (min(H, W) / 2.0)
    S = SoftCoverage.apply(q, count, tile, inv_s, 1.0 / sigma)  # (B, A, tp)
    per_tile = scatter_active(S, bins)                      # (B, T, tp)
    if not return_sum:
        per_tile = 1.0 - torch.exp(-per_tile)
    return untile_image(per_tile, image_size, tile, bins.n_tiles_hw)


def soft_silhouette_cuda(
    meshes, camera, sigma: float = 1e-4, tile: int = 16,
    faces_per_tile: int = 128, active_tiles: int | None = None,
    layout: str = "lane", group_lanes: int | None = None,
    hi_tiles: int | None = None, lo_lanes: int = 32,
) -> torch.Tensor:
    """Public entry: meshes + camera -> soft silhouette (B, H, W)."""
    fp = setup_face_planes(meshes, camera)
    return soft_silhouette_fd(
        fp, camera.image_size, sigma=sigma, tile=tile,
        faces_per_tile=faces_per_tile, active_tiles=active_tiles,
        layout=layout, group_lanes=group_lanes,
        hi_tiles=hi_tiles, lo_lanes=lo_lanes,
    )


# ---------------------------------------------------------------------------
# Budget sizing (setup time: each reads device values back once)
# ---------------------------------------------------------------------------

def suggest_faces_per_tile(fp: FacePlanes, image_size, tile: int = 16,
                           sigma: float = 1e-4, margin: float = 1.3) -> int:
    """Smallest safe (no-overflow) faces_per_tile for this scene, with
    headroom, rounded up to a multiple of 128 (the JAX package's rounding,
    kept so both packages size identical budgets)."""
    pad = math.sqrt(SOFT_CUTOFF * sigma)
    max_count, _ = count_overflow(fp, image_size, tile, 0, pad)
    want = int(math.ceil(float(max_count) * margin / 128)) * 128
    return max(128, min(want, fp.num_faces))


def suggest_active_tiles(fp: FacePlanes, image_size, tile: int = 16,
                         sigma: float = 1e-4, margin: float = 1.3) -> int:
    """Smallest safe active-tile budget for this scene (max non-empty tile
    count over the batch, with headroom)."""
    pad = math.sqrt(SOFT_CUTOFF * sigma)
    return suggest_active_tiles_fd(fp, image_size, tile, pad, margin=margin)


def suggest_layout(faces_per_tile: int) -> str:
    """The JAX package's layout rule ("packed" for thin bins). Both layouts
    run the same kernels here; the rule is kept so configs agree."""
    return "packed" if faces_per_tile <= 128 else "lane"


def suggest_group_lanes(fp: FacePlanes, image_size, tile: int = 16,
                        sigma: float = 1e-4, active_tiles: int = 128,
                        faces_per_tile: int = 128,
                        margin: float = 1.3, order: str = "tile") -> int:
    """The packed layout's per-group lane budget for this scene (sizing
    only: the port drops no candidate for it). Pass order="count" with
    hi_tiles, whose count-ordered tiles group otherwise."""
    pad = math.sqrt(SOFT_CUTOFF * sigma)
    return suggest_group_lanes_fd(fp, image_size, tile, pad, active_tiles,
                                  faces_per_tile, margin=margin, order=order)


def suggest_occupancy_split(fp: FacePlanes, image_size, tile: int = 16,
                            sigma: float = 1e-4, active_tiles: int = 128,
                            lo_lanes: int = 32,
                            margin: float = 1.3) -> int | None:
    """hi_tiles for the packed layout's occupancy split: the count-ordered
    active slots that hold more than lo_lanes candidates, with headroom, a
    multiple of 8; None when the split would not help (nothing exceeds
    lo_lanes, or most tiles do). Candidates of a tail tile beyond lo_lanes
    are dropped, so footprints that move during a fit need margin."""
    pad = math.sqrt(SOFT_CUTOFF * sigma)
    bins = bin_faces_active(fp, image_size, tile, pad, active_tiles,
                            order="count")
    n_hi = int((bins.count > lo_lanes).sum(1).max())
    want = int(math.ceil(n_hi * margin / 8)) * 8
    if want <= 0 or want >= bins.count.shape[1]:
        return None
    return want


class SoftKernelConfig(NamedTuple):
    """Static sizing bundle for soft_silhouette_fd; splat it with
    ``soft_silhouette_fd(fp, image_size, sigma=sigma, **cfg.kwargs())``."""

    tile: int
    faces_per_tile: int
    active_tiles: int | None
    layout: str
    group_lanes: int | None
    hi_tiles: int | None = None
    lo_lanes: int = 32

    def kwargs(self) -> dict:
        return self._asdict()


def suggest_soft_config(fps, image_size, tile: int = 16, sigma: float = 1e-4,
                        margin: float = 1.3, layout: str = "auto",
                        split: bool = False) -> SoftKernelConfig:
    """One-call scene sizing. fps: one FacePlanes or several (e.g. a fit's
    start and target poses); every budget is the max over them. Call once at
    setup: the result is a bundle of Python ints.

    split=True also sizes the packed layout's occupancy split
    (suggest_occupancy_split at lo_lanes 32; None unless every projection
    has one), and then group_lanes in count order. It suits static scenes:
    the split drops a tail tile's candidates beyond lo_lanes, which a moving
    footprint can outgrow."""
    if isinstance(fps, FacePlanes):
        fps = (fps,)
    fps = tuple(fps)
    if not fps:
        raise ValueError("suggest_soft_config needs at least one projection")
    fpt = max(suggest_faces_per_tile(fp, image_size, tile, sigma,
                                     margin=margin) for fp in fps)
    act = max(suggest_active_tiles(fp, image_size, tile, sigma,
                                   margin=margin) for fp in fps)
    if layout == "auto":
        layout = suggest_layout(fpt)
    if layout == "lane":
        return SoftKernelConfig(tile, fpt, act, "lane", None)
    hi, lo = None, 32
    if split:
        his = [suggest_occupancy_split(fp, image_size, tile, sigma,
                                       active_tiles=act, lo_lanes=lo,
                                       margin=margin) for fp in fps]
        hi = None if None in his else max(his)
    gl = max(suggest_group_lanes(fp, image_size, tile, sigma,
                                 active_tiles=act, faces_per_tile=fpt,
                                 margin=margin,
                                 order="count" if hi else "tile")
             for fp in fps)
    return SoftKernelConfig(tile, fpt, act, "packed", gl, hi, lo)

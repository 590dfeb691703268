"""Tile-binned hard (nearest-face) rasterization through hand-written CUDA
kernels (PyTorch counterpart of ``torch_renderer_tpu.rasterize.pallas_hard``).

The path: bin faces into active tiles (binning.bin_faces_active; with no
active-tile budget every tile gets a slot), gather each tile's candidates
into (B, A, Fmax, 13) slabs (12 corner channels plus the global face id)
with an int32 count per tile (the tile-gather kernel, cuda_gather), run a
selection kernel, and write each per-tile field into the (B, H, W, K)
image with the empty-fragment background in tiles with no active slot
(the untile kernel, cuda_untile: one launch for the four Fragments
fields).

  * K = 1: ``hard_k1`` finds each pixel's nearest covering face and
    interpolates it in-kernel (zbuf, perspective-correct barycentrics,
    signed boundary distance, global face id).
  * K > 1: ``topk_select`` keeps each pixel's K nearest covering faces, as
    winner slots only; their values are re-derived in torch. The kernel
    splits a tile's candidates among several thread groups per pixel,
    skips a face for a warp whose pixels miss its conservatively grown
    bounding box, and merges the groups' lists in (depth, slot) order:
    the winners are those of one stable pass over the slots.

Both kernels take any tile and ``topk_select`` any K: a tile of more than
1024 pixels spans several blocks, and where not even one warp's
top-K lists fit in shared memory (K > 812) they live in device memory, in
the output and a depth scratch the wrapper allocates.

A face covers a pixel when the pixel is inside it (or within squared
distance blur of its boundary) and its selection z, interpolated with
relu-clipped barycentrics, is above znear. Ties keep the lower slot, i.e.
the lower face id.

Gradients: selection is not differentiable. Values and gradients come from
a differentiable indexed gather of the winners' 12 corner channels by
global face id, followed by geometry.fragment_math (``reinterpolate``). For
K = 1 the ``HardK1`` autograd Function returns the kernel's in-kernel
values and backpropagates through that re-interpolation; for K > 1 autograd
runs through it directly. Neither kernel has a backward kernel, as the JAX
package has none.

For every kernel the module keeps its plain PyTorch version
(``hard_k1_reference``, ``topk_select_reference``): a wrapper uses it for a
tensor on the CPU, launches the kernel for a CUDA tensor, and raises for
anything else.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .._build import launch, load_kernels
from ..utils.timing import count as count_event, span
from .binning import (
    ActiveBins,
    bin_faces_active,
    check_budget,
    face_channel_planes,
    split_bins,
    tile_channel_slabs,
    tile_grid,
)
from .cuda_untile import tile_slot_table, untile_scatter_fields
from .fragments import EMPTY_DIST, Fragments
from .geometry import channel_edge_bary, channel_min_edge_dist2, fragment_math

# Each launch adds 1 to the utils.timing counter "hard_k1" or
# "topk_select": the launches made from the host (an eager call, a graph's
# warm-up or capture); a replay launches from its graph and counts
# nothing.

INF = 3.0e38
SLAB_CHANNELS = 13
# Per-field values of a pixel with no hit: zbuf, pc0, pc1, pc2, dists, face
# id, live, winner slot (the JAX kernels' empty band).
EMPTY_BAND = (-1.0, 0.0, 0.0, 0.0, EMPTY_DIST, -1.0, 0.0, 0.0)


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the kernels
# ---------------------------------------------------------------------------

def pixel_xy(origin: torch.Tensor, tile: int, inv_s: float):
    """Absolute raster coordinates (B, A, tile^2) of each active tile's
    pixels: origin + (p % tile, p // tile) * inv_s, as the kernels compute
    them."""
    idx = torch.arange(tile * tile, device=origin.device)
    xoff = (idx % tile).to(torch.float32) * inv_s
    yoff = (idx // tile).to(torch.float32) * inv_s
    return origin[..., 0:1] + xoff, origin[..., 1:2] + yoff


def _priority(slab, count, origin, tile: int, inv_s: float, blur: float,
              znear: float) -> torch.Tensor:
    """Selection z (B, A, tile^2, Fmax) of every (pixel, slot) pair where
    the slot's face covers the pixel, INF elsewhere; the kernels' selection
    arithmetic, operation for operation. Slots at or beyond the largest
    count are never live, so only the first max(count) slots are
    evaluated (at least one, so every reduction has an operand)."""
    slab = slab[:, :, :max(1, int(count.max()))]
    px, py = pixel_xy(origin, tile, inv_s)
    px, py = px[..., None], py[..., None]                     # (B, A, P, 1)
    ch = [slab[..., None, :, c] for c in range(SLAB_CHANNELS)]  # (B, A, 1, F)
    qx, qy, invz = ch[0:6:2], ch[1:6:2], ch[9:12]
    bary, inside = channel_edge_bary(px, py, qx, qy)
    rb = [torch.relu(b) for b in bary]
    den = (rb[0] * invz[0] + rb[1] * invz[1] + rb[2] * invz[2]).clamp_min(1e-12)
    zsel = (rb[0] + rb[1] + rb[2]) / den
    cover = inside
    if blur > 0.0:
        cover = cover | (channel_min_edge_dist2(px, py, qx, qy) < blur)
    F = slab.shape[2]
    live = (torch.arange(F, device=slab.device)
            < count.to(torch.int64)[..., None, None])        # (B, A, 1, F)
    cover = cover & live & (zsel > znear)
    return torch.where(cover, zsel, torch.full_like(zsel, INF))


def _winner_values(slab, lane, origin, tile, inv_s, clip_bary):
    """zbuf, pc 3-list, dists (B, A, K, P) of slab rows lane (B, A, K, P)."""
    B, A, K, P = lane.shape
    sel = slab.gather(2, lane.reshape(B, A, K * P, 1).long()
                      .expand(B, A, K * P, SLAB_CHANNELS))
    sel = sel.reshape(B, A, K, P, SLAB_CHANNELS)
    px, py = pixel_xy(origin, tile, inv_s)
    px, py = px[:, :, None], py[:, :, None]                   # (B, A, 1, P)
    ch = [sel[..., c] for c in range(SLAB_CHANNELS)]
    zbuf, pc, dists = fragment_math(px, py, ch[0:6:2], ch[1:6:2], ch[6:9],
                                    ch[9:12], clip_bary)
    return zbuf, pc, dists, ch[12]


def hard_k1_reference(slab, count, origin, tile: int, inv_s: float,
                      blur: float, znear: float,
                      clip_bary: bool) -> torch.Tensor:
    """Plain version of the K=1 kernel: out (B, A, 8, tile^2), rows zbuf,
    pc0, pc1, pc2, dists, face id, live, winner slot (EMPTY_BAND where no
    face covers the pixel)."""
    prio = _priority(slab, count, origin, tile, inv_s, blur, znear)
    lane = prio.argmin(-1)                           # first minimal slot
    live = prio.gather(-1, lane[..., None])[..., 0] < INF   # (B, A, P)
    zbuf, pc, dists, fid = _winner_values(slab, lane[:, :, None], origin,
                                          tile, inv_s, clip_bary)
    rows = [zbuf, pc[0], pc[1], pc[2], dists, fid,
            torch.ones_like(zbuf), lane[:, :, None].to(torch.float32)]
    out = torch.stack([r[:, :, 0] for r in rows], dim=2)     # (B, A, 8, P)
    empty = torch.tensor(EMPTY_BAND, dtype=torch.float32,
                         device=slab.device)[:, None]
    return torch.where(live[:, :, None], out, empty)


def topk_select_reference(slab, count, origin, K: int, tile: int,
                          inv_s: float, blur: float,
                          znear: float) -> torch.Tensor:
    """Plain version of the top-K kernel: winner slots (B, A, K, tile^2)
    int32 of the K nearest covering faces per pixel, ascending in selection
    z, ties in ascending slot order; -1 where fewer than K faces cover."""
    prio = _priority(slab, count, origin, tile, inv_s, blur, znear)
    z, idx = torch.sort(prio, dim=-1, stable=True)
    z, idx = z[..., :K], idx[..., :K]
    lane = torch.where(z < INF, idx, torch.full_like(idx, -1))
    if lane.shape[-1] < K:
        lane = torch.nn.functional.pad(lane, (0, K - lane.shape[-1]),
                                       value=-1)
    return lane.transpose(2, 3).to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_inputs(slab, count, origin, tile: int):
    if slab.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no hard-raster kernel for device {slab.device}")
    if (slab.dtype != torch.float32 or slab.ndim != 4
            or slab.shape[-1] != SLAB_CHANNELS):
        raise ValueError(f"slab must be float32 (B, A, F, {SLAB_CHANNELS}), "
                         f"got {slab.dtype} {tuple(slab.shape)}")
    B, A, F, _ = slab.shape
    if F == 0:
        raise ValueError("slab must hold at least one slot per tile")
    if count.dtype != torch.int32 or tuple(count.shape) != (B, A):
        raise ValueError(f"count must be int32 ({B}, {A}), got {count.dtype} "
                         f"{tuple(count.shape)}")
    if origin.dtype != torch.float32 or tuple(origin.shape) != (B, A, 2):
        raise ValueError(f"origin must be float32 ({B}, {A}, 2), got "
                         f"{origin.dtype} {tuple(origin.shape)}")
    if tile <= 0:
        raise ValueError(f"tile must be positive; got {tile}")
    if any(t.device != slab.device for t in (count, origin)):
        raise ValueError("slab, count and origin must be on one device")
    if slab.device.type == "cuda" and not all(
            t.is_contiguous() for t in (slab, count, origin)):
        raise ValueError("the CUDA kernels take contiguous tensors")


def hard_k1(slab, count, origin, tile: int, inv_s: float, blur: float,
            znear: float, clip_bary: bool) -> torch.Tensor:
    """out (B, A, 8, tile^2): per pixel of each active tile, the nearest
    face among the first count[b, a] slots of slab (B, A, F, 13) that
    covers it, interpolated (rows as in hard_k1_reference)."""
    _check_inputs(slab, count, origin, tile)
    if slab.device.type == "cpu":
        return hard_k1_reference(slab, count, origin, tile, inv_s, blur,
                                 znear, clip_bary)
    B, A, F, _ = slab.shape
    out = slab.new_empty((B, A, 8, tile * tile))  # the kernel writes all
    launch("trt_hard_k1", slab.data_ptr(), count.data_ptr(),
            origin.data_ptr(), out.data_ptr(), B, A, F, tile, inv_s, blur,
            znear, int(clip_bary), device=slab.device)
    count_event("hard_k1")
    return out


def topk_select(slab, count, origin, K: int, tile: int, inv_s: float,
                blur: float, znear: float) -> torch.Tensor:
    """Winner slots (B, A, K, tile^2) int32 of the K nearest covering faces
    per pixel (-1 = none), ascending in selection z."""
    _check_inputs(slab, count, origin, tile)
    if K <= 0:
        raise ValueError(f"K must be positive; got {K}")
    if slab.device.type == "cpu":
        return topk_select_reference(slab, count, origin, K, tile, inv_s,
                                     blur, znear)
    B, A, F, _ = slab.shape
    lane = torch.empty((B, A, K, tile * tile), dtype=torch.int32,
                       device=slab.device)        # the kernel writes all
    # the lists' depths, where they live in device memory
    zs = (torch.empty(lane.shape, dtype=torch.float32, device=slab.device)
          if load_kernels().trt_topk_device_lists(K) else None)
    launch("trt_topk_select", slab.data_ptr(), count.data_ptr(),
           origin.data_ptr(), lane.data_ptr(),
           None if zs is None else zs.data_ptr(), B, A, F, K, tile, inv_s,
           blur, znear, device=slab.device)
    count_event("topk_select")
    return lane


# ---------------------------------------------------------------------------
# Differentiable re-interpolation and the K=1 autograd Function
# ---------------------------------------------------------------------------

def reinterpolate(planes, fid, live, origin, tile: int, inv_s: float,
                  clip_bary: bool):
    """Differentiable fragment values of the winners: planes (B, F, 12)
    corner channels, fid (B, A, K, P) global face ids, live (B, A, K, P)
    -> zbuf, pc 3-list, dists, each (B, A, K, P). Dead slots read zeros
    (finite values, zero gradient), as the JAX one-hot pick does."""
    B, A, K, P = fid.shape
    sel = planes.gather(1, fid.reshape(B, -1, 1).expand(B, A * K * P, 12))
    sel = sel.reshape(B, A, K, P, 12)
    sel = torch.where(live[..., None], sel, torch.zeros_like(sel))
    px, py = pixel_xy(origin, tile, inv_s)
    ch = [sel[..., c] for c in range(12)]
    return fragment_math(px[:, :, None], py[:, :, None], ch[0:6:2],
                         ch[1:6:2], ch[6:9], ch[9:12], clip_bary)


class HardK1(torch.autograd.Function):
    """hard_k1 as a differentiable op: the kernel's in-kernel values
    forward; the gradient of rows 0-4 (zbuf, pc, dists) flows to planes
    through ``reinterpolate`` of the winners."""

    @staticmethod
    def forward(ctx, planes, slab, count, origin, tile, inv_s, blur, znear,
                clip_bary):
        out = hard_k1(slab, count, origin, tile, inv_s, blur, znear,
                      clip_bary)
        ctx.save_for_backward(planes, origin, out)
        ctx.params = (tile, inv_s, clip_bary)
        return out

    @staticmethod
    def backward(ctx, g):
        planes, origin, out = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return (None,) * 9
        tile, inv_s, clip_bary = ctx.params
        live = (out[:, :, 6] > 0)[:, :, None]                 # (B, A, 1, P)
        fid = out[:, :, 5].clamp_min(0).long()[:, :, None]
        with torch.enable_grad():
            p = planes.detach().requires_grad_(True)
            zbuf, pc, dists = reinterpolate(p, fid, live, origin, tile,
                                            inv_s, clip_bary)
            rows = torch.stack([zbuf, pc[0], pc[1], pc[2], dists], dim=2)
            gsel = (g[:, :, :5] * live)[:, :, :, None]        # (B, A, 5, 1, P)
            (dp,) = torch.autograd.grad(rows, p, gsel)
        return (dp,) + (None,) * 8


# ---------------------------------------------------------------------------
# Public surface
# ---------------------------------------------------------------------------

def _to_images(fields: dict, table, image_size, tile: int,
               n_tiles_hw) -> dict:
    """{name: (values (B, A, P, K, ...), bg)} active-tile fields ->
    {name: (B, H, W, K, ...)} through one launch of the untile kernel and
    the tile slot table. Each field's trailing dimensions merge into the
    kernel's channels as a view (binned_tile_fields lays them out so), and
    the kernel reads them at their strides."""
    flat = [(v.reshape(v.shape[:3] + (-1,)), bg) for v, bg in fields.values()]
    imgs = untile_scatter_fields(flat, table, image_size, tile, n_tiles_hw)
    return {name: img.reshape(img.shape[:3] + tuple(v.shape[3:]))
            for (name, (v, _)), img in zip(fields.items(), imgs)}


class BinnedInputs(NamedTuple):
    """What a binned raster hands the kernels, and what maps their output
    back to the image."""

    bins: ActiveBins
    planes: torch.Tensor   # (B, F, 12) corner channels, differentiable
    slab: torch.Tensor     # (B, A, Fmax, 13) candidates, detached
    count: torch.Tensor    # (B, A) int32
    table: torch.Tensor    # (B, A, Fmax) int64 face id of each slot
    origin: torch.Tensor   # (B, A, 2) raster coords of each tile's pixel 0
    inv_s: float           # raster units per pixel


def binned_inputs(fd, settings) -> BinnedInputs:
    """Bin fd (FacePlanes or FaceRasterData) into the tiles of resolved
    settings (bin_size > 0), run the opt-in budget checks, and gather the
    kernels' inputs. Faces beyond max_faces_per_bin in a tile and non-empty
    tiles beyond active_tiles are dropped.

    occupancy_split (hi, lo), as the JAX package's binned path applies it:
    the active tiles are ranked by descending candidate count; the first
    max(1, hi) keep max_faces_per_bin slots and the rest min(lo,
    max_faces_per_bin), dropping their higher-id candidates beyond it
    (binning.split_bins). hi at or above the active-tile count means no
    split. Binning and the budget checks run in the span "binning", the
    candidate gather in "raster"."""
    H, W = settings.image_size
    tile = settings.bin_size
    blur = settings.blur_radius
    TH, TW, _ = tile_grid((H, W), tile)
    A = TH * TW if settings.active_tiles is None else settings.active_tiles
    Fmax = min(settings.max_faces_per_bin, fd.num_faces)
    split = settings.occupancy_split
    with span("binning", fd.valid):
        bins = bin_faces_active(fd, (H, W), tile,
                                math.sqrt(blur) if blur > 0 else 0.0, A,
                                order="tile" if split is None else "count")
        if settings.active_tiles is not None:
            check_budget("active_tiles", bins.n_active.max(),
                         settings.active_tiles, settings.check_budgets,
                         hint="size with binning.suggest_active_tiles_fd")
        check_budget("max_faces_per_bin", bins.count.max(), Fmax,
                     settings.check_budgets,
                     hint="size with cuda_soft.suggest_faces_per_tile")
        if split is not None and int(split[0]) < bins.count.shape[1]:
            hi, lo = max(1, int(split[0])), int(split[1])
            check_budget("occupancy_split lo_lanes",
                         bins.count[:, hi:].max(), lo,
                         settings.check_budgets,
                         hint="size with binning.suggest_occupancy_split_fd")
            bins = split_bins(bins, hi, min(lo, Fmax))
    planes = face_channel_planes(fd)
    with span("raster", planes):
        slab, count, table = tile_channel_slabs(planes.detach(), bins, Fmax)
    return BinnedInputs(bins, planes, slab, count, table,
                        bins.origin.contiguous(), 1.0 / (min(H, W) / 2.0))


def binned_tile_fields(fd, settings):
    """Selection and interpolation on the active tiles: (bins, {field:
    (values (B, A, tile^2, K, ...), background)}) for the four Fragments
    fields, before the epilogue maps them to the image. The selection
    and interpolation run in the span "raster"."""
    bins, planes, slab, count, table, origin, inv_s = binned_inputs(
        fd, settings)
    with span("raster", planes) as sp:
        fields = _select(sp.inputs(planes), slab, count, table, origin,
                         inv_s, settings)
        return bins, sp.outputs(fields)


def _select(planes, slab, count, table, origin, inv_s, settings) -> dict:
    """binned_tile_fields' selection and interpolation on the kernels'
    inputs."""
    K = settings.faces_per_pixel
    tile = settings.bin_size
    blur = settings.blur_radius
    if K == 1:
        out = HardK1.apply(planes, slab, count, origin, tile, inv_s, blur,
                           settings.znear, settings.clip_bary)
        zbuf, dists = out[:, :, 0, :, None], out[:, :, 4, :, None]
        bary = out[:, :, 1:4].transpose(2, 3)[:, :, :, None]  # (B,A,P,1,3)
        p2f = out[:, :, 5, :, None].round().long()
    else:
        lane = topk_select(slab, count, origin, K, tile, inv_s, blur,
                           settings.znear)                  # (B, A, K, P)
        B, A_, _, P = lane.shape
        live = lane >= 0
        fid = table.gather(2, lane.clamp_min(0).long().reshape(B, A_, K * P))
        # a tile with no candidate holds -1 in slot 0
        fid = fid.clamp_min(0).reshape(B, A_, K, P)
        zb, pc, dd = reinterpolate(planes, fid, live, origin, tile, inv_s,
                                   settings.clip_bary)
        zbuf = torch.where(live, zb, -1.0).transpose(2, 3)
        dists = torch.where(live, dd, EMPTY_DIST).transpose(2, 3)
        # (B, A, K, 3, P): the (K, 3) dims of the (B, A, P, K, 3) view
        # below merge into K * 3 channels without a copy
        bary = torch.where(live[:, :, :, None], torch.stack(pc, dim=3), 0.0)
        bary = bary.permute(0, 1, 4, 2, 3)                    # (B,A,P,K,3)
        p2f = torch.where(live, fid, -1).transpose(2, 3)
    return {"pix_to_face": (p2f, -1), "zbuf": (zbuf, -1.0),
            "bary": (bary, 0.0), "dists": (dists, EMPTY_DIST)}


def rasterize_binned_cuda(fd, settings) -> Fragments:
    """Coarse-to-fine top-K rasterization through the CUDA kernels; the
    counterpart of ``rasterize_binned_pallas``. fd: FacePlanes or
    FaceRasterData; settings: a resolved RasterizationSettings (bin_size >
    0). The epilogue runs in the span "untile"."""
    bins, fields = binned_tile_fields(fd, settings)
    with span("untile", bins.rank) as sp:
        table = tile_slot_table(bins.rank, bins.invrank.shape[1],
                                bins.n_tiles_hw)
        return sp.outputs(Fragments(**_to_images(
            sp.inputs(fields), table, settings.image_size,
            settings.bin_size, bins.n_tiles_hw)))

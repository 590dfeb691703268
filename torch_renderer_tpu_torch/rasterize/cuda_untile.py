"""Fused scatter + untile through a hand-written CUDA kernel (PyTorch
counterpart of ``torch_renderer_tpu.rasterize.pallas_untile``).

The binned mesh raster ends with per-tile fields on the compacted active
tiles, (B, A, tile^2, ...). Its plain epilogue scatters them back to the
full tile grid with the background (binning.scatter_active_bg) and untiles
the grid into the image (binning.untile_image): two passes over the image
and a reshape copy. ``untile_scatter`` writes the cropped image in one
pass instead, through a per-tile slot table (``tile_slot_table``: the slot
of each tile, A = background), and copies float32 and int64 fields alike.
``untile_scatter_fields`` untiles several fields of one raster in one
launch: it is the epilogue of every binned mesh raster (cuda_hard), one
launch for the four Fragments fields.

``UntileScatterFields`` makes it differentiable: the backward is the exact
inverse in plain torch, per float field (tile the cotangent image, then
gather each active slot's tile row back; the background's cotangent is
dropped), as the JAX package's backward is XLA and not a kernel.

The module keeps the kernel's plain PyTorch version
(``untile_scatter_reference``): the wrapper uses it for a tensor on the
CPU, launches the kernel for a CUDA tensor, and raises for anything else.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from .._build import launch
from ..utils.timing import count as count_event
from .binning import gather_rows_bg, untile_image

# Each launch adds 1 to the utils.timing counter "untile_scatter": the
# launches made from the host (an eager call, a graph's warm-up or
# capture); a replay launches from its graph and counts nothing.

_MAX_FIELDS = 8   # field descriptors one launch takes (csrc/untile.cu)


def tile_slot_table(rank, A: int, n_tiles_hw, batch: int = 1,
                    device=None) -> torch.Tensor:
    """(B, T) int32 slot of each tile for untile_scatter, from
    ActiveBins.rank ((B, T); A or more means no active slot), with every
    empty tile clipped to the background slot A. ``rank=None`` gives the
    identity table of the uncompacted grid (A = T; ``batch`` rows on
    ``device``)."""
    TH, TW = n_tiles_hw
    if rank is None:
        T = TH * TW
        return torch.arange(T, dtype=torch.int32, device=device).expand(
            batch, T).contiguous()
    return rank.clamp(0, A).to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def untile_scatter_reference(rows, tileof, bg, image_size, tile: int,
                             n_tiles_hw) -> torch.Tensor:
    """Plain version of the kernel on one field: scatter_active_bg through
    the slot table, then untile_image. rows (B, A, tile^2, C) ->
    (B, H, W, C)."""
    return untile_image(gather_rows_bg(rows, tileof, bg), image_size, tile,
                        n_tiles_hw)


def untile_scatter_fields_reference(fields, tileof, image_size, tile: int,
                                    n_tiles_hw) -> list:
    """Plain version of the kernel on several fields: the one-field plain
    version on each (rows, bg) of fields."""
    return [untile_scatter_reference(rows, tileof, bg, image_size, tile,
                                     n_tiles_hw) for rows, bg in fields]


def tile_image(img: torch.Tensor, tile: int, n_tiles_hw) -> torch.Tensor:
    """(B, H, W, ...) -> (B, T, tile^2, ...): the inverse of untile_image,
    zero-padding H and W up to the tile grid."""
    TH, TW = n_tiles_hw
    B, H, W = img.shape[:3]
    trail = tuple(img.shape[3:])
    ph, pw = TH * tile - H, TW * tile - W
    if ph or pw:
        full = img.new_zeros((B, TH * tile, TW * tile) + trail)
        full[:, :H, :W] = img
        img = full
    a = img.reshape((B, TH, tile, TW, tile) + trail).movedim(2, 3)
    return a.reshape((B, TH * TW, tile * tile) + trail)


def compact_rows(values: torch.Tensor, tileof: torch.Tensor,
                 A: int) -> torch.Tensor:
    """(B, T, ...) -> (B, A, ...): the sum of the tile rows each slot is
    the source of (the transpose of gather_rows_bg; tiles at slot A or
    beyond, the background, add nowhere)."""
    B, T = values.shape[:2]
    trail = tuple(values.shape[2:])
    idx = tileof.long().clamp(max=A)
    idx = idx.reshape((B, T) + (1,) * len(trail)).expand((B, T) + trail)
    out = values.new_zeros((B, A + 1) + trail)
    return out.scatter_add_(1, idx, values)[:, :A]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _bg_bits(bg, dtype: torch.dtype) -> int:
    """The bit pattern of the scalar bg in dtype (4 or 8 bytes), as the
    kernel's background word (on the host: no tensor is made)."""
    if dtype.is_floating_point:
        f, i = ("<f", "<i") if dtype.itemsize == 4 else ("<d", "<q")
        return struct.unpack(i, struct.pack(f, float(bg)))[0]
    return int(bg)


def untile_scatter_fields_fwd(fields, tileof, image_size, tile: int,
                              n_tiles_hw) -> list:
    """The kernel, once for all fields: fields a list of (rows, bg) with
    rows (B, A, tile^2, C) of 4- or 8-byte elements (any strides, C per
    field), tileof (B, TH * TW) int32 -> the cropped images (B, H, W, C),
    one per field."""
    H, W = image_size
    TH, TW = n_tiles_hw
    if not 0 < len(fields) <= _MAX_FIELDS:
        raise ValueError(f"untile takes 1 to {_MAX_FIELDS} fields, got "
                         f"{len(fields)}")
    B, A = fields[0][0].shape[:2]
    dev = fields[0][0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no untile kernel for device {dev}")
    for rows, _ in fields:
        if rows.ndim != 4 or rows.shape[2] != tile * tile \
                or tuple(rows.shape[:2]) != (B, A):
            raise ValueError(f"rows must be ({B}, {A}, {tile * tile}, C), "
                             f"got {tuple(rows.shape)}")
        if rows.device != dev or tileof.device != dev:
            raise ValueError("rows and tileof must be on one device")
    if tileof.dtype != torch.int32 or tuple(tileof.shape) != (B, TH * TW):
        raise ValueError(f"tileof must be int32 ({B}, {TH * TW}), got "
                         f"{tileof.dtype} {tuple(tileof.shape)}")
    if not (0 < H <= TH * tile and 0 < W <= TW * tile):
        raise ValueError(f"image {H}x{W} does not fit the {TH}x{TW} grid "
                         f"of tile {tile}")
    if dev.type == "cpu":
        return untile_scatter_fields_reference(fields, tileof, image_size,
                                               tile, n_tiles_hw)
    for rows, _ in fields:
        if rows.element_size() not in (4, 8) or rows.is_complex() \
                or rows.dtype == torch.bool:
            raise ValueError(f"the untile kernel copies 4- or 8-byte "
                             f"values, got {rows.dtype}")
    if not tileof.is_contiguous():
        raise ValueError("the CUDA kernels take a contiguous tileof")
    # the kernel writes every pixel of every field it is given
    outs = [rows.new_empty((B, H, W, rows.shape[3])) for rows, _ in fields]
    todo = [(rows, bg, out) for (rows, bg), out in zip(fields, outs)
            if out.numel()]
    if not todo:
        return outs
    desc = (ctypes.c_int64 * (9 * len(todo)))(*[
        v for rows, bg, out in todo
        for v in (rows.data_ptr(), out.data_ptr(), rows.element_size(),
                  rows.shape[3], *rows.stride(), _bg_bits(bg, rows.dtype))])
    launch("trt_untile_scatter_fields", ctypes.addressof(desc), len(todo),
           tileof.data_ptr(), B, H, W, tile, TH, TW, A, device=dev)
    count_event("untile_scatter")
    return outs


def untile_scatter_fwd(rows, tileof, bg, image_size, tile: int,
                       n_tiles_hw) -> torch.Tensor:
    """The kernel on one field: rows (B, A, tile^2, C) of 4- or 8-byte
    elements (any strides), tileof (B, TH * TW) int32, bg a scalar -> the
    cropped image (B, H, W, C)."""
    return untile_scatter_fields_fwd([(rows, bg)], tileof, image_size, tile,
                                     n_tiles_hw)[0]


class UntileScatterFields(torch.autograd.Function):
    """untile_scatter_fields as one differentiable op: the forward is one
    kernel launch; the backward is the exact inverse in plain torch, per
    float field (integer fields take no gradient)."""

    @staticmethod
    def forward(ctx, tileof, bgs, image_size, tile, n_tiles_hw, *rows):
        ctx.set_materialize_grads(False)     # an unused field: no work
        ctx.save_for_backward(tileof)
        ctx.params = (rows[0].shape[1], tile, n_tiles_hw)
        outs = untile_scatter_fields_fwd(list(zip(rows, bgs)), tileof,
                                         image_size, tile, n_tiles_hw)
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        (tileof,) = ctx.saved_tensors
        A, tile, n_tiles_hw = ctx.params
        d_rows = tuple(
            None if g is None or not ctx.needs_input_grad[5 + i]
            else compact_rows(tile_image(g, tile, n_tiles_hw), tileof, A)
            for i, g in enumerate(grads))
        return (None,) * 5 + d_rows


def untile_scatter_fields(fields, tileof, image_size, tile: int,
                          n_tiles_hw) -> list:
    """Several fields of one raster, each (rows (B, A, tile^2, C), bg), to
    their cropped images (B, H, W, C) in one kernel launch; differentiable
    with respect to each float field's rows."""
    rows, bgs = zip(*fields)
    return list(UntileScatterFields.apply(tileof, bgs, image_size, tile,
                                          n_tiles_hw, *rows))


def untile_scatter(rows, tileof, bg, image_size, tile: int,
                   n_tiles_hw) -> torch.Tensor:
    """Compacted per-tile rows (B, A, tile^2, C) -> the cropped image
    (B, H, W, C) in one pass: tile t takes row tileof[b, t] when it is
    below A, else the scalar bg. Differentiable with respect to rows."""
    return untile_scatter_fields([(rows, bg)], tileof, image_size, tile,
                                 n_tiles_hw)[0]

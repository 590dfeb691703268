"""Fused scatter + untile through a hand-written CUDA kernel (PyTorch
counterpart of ``torch_renderer_tpu.rasterize.pallas_untile``).

The binned mesh raster ends with per-tile fields on the compacted active
tiles, (B, A, tile^2, ...). Its plain epilogue scatters them back to the
full tile grid with the background (binning.scatter_active_bg) and untiles
the grid into the image (binning.untile_image): two passes over the image
and a reshape copy. ``untile_scatter`` writes the cropped image in one
pass instead, through a per-tile slot table (``tile_slot_table``: the slot
of each tile, A = background). It is the epilogue of every binned mesh
raster (cuda_hard), one launch per fragment field, and copies float32 and
int64 fields alike.

``UntileScatter`` makes it differentiable: the backward is the exact
inverse in plain torch (tile the cotangent image, then gather each active
slot's tile row back; the background's cotangent is dropped), as the JAX
package's backward is XLA and not a kernel.

The module keeps the kernel's plain PyTorch version
(``untile_scatter_reference``): the wrapper uses it for a tensor on the
CPU, launches the kernel for a CUDA tensor, and raises for anything else.
"""

from __future__ import annotations

import torch

from .._build import launch
from .binning import gather_rows_bg, untile_image

# Kernel launches since import (or since a caller reset them): one per
# launched kernel, counted where the wrapper launches it and nowhere else.
UNTILE_LAUNCHES = 0


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
    """Plain version of the kernel: scatter_active_bg through the slot
    table, then untile_image. rows (B, A, tile^2, C) -> (B, H, W, C)."""
    return untile_image(gather_rows_bg(rows, tileof, bg), image_size, tile,
                        n_tiles_hw)


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
# Kernel wrapper
# ---------------------------------------------------------------------------

def _bg_bits(bg, dtype: torch.dtype) -> int:
    """The bit pattern of the scalar bg in dtype (4 or 8 bytes), as the
    kernel's background word."""
    word = torch.int32 if dtype.itemsize == 4 else torch.int64
    return int(torch.tensor(bg, dtype=dtype).view(word))


def untile_scatter_fwd(rows, tileof, bg, image_size, tile: int,
                       n_tiles_hw) -> torch.Tensor:
    """The kernel: rows (B, A, tile^2, C) of 4- or 8-byte elements (any
    strides), tileof (B, TH * TW) int32, bg a scalar -> the cropped image
    (B, H, W, C)."""
    global UNTILE_LAUNCHES
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no untile kernel for device {rows.device}")
    H, W = image_size
    TH, TW = n_tiles_hw
    if rows.ndim != 4 or rows.shape[2] != tile * tile:
        raise ValueError(f"rows must be (B, A, {tile * tile}, C), got "
                         f"{tuple(rows.shape)}")
    B, A, _, C = rows.shape
    if tileof.dtype != torch.int32 or tuple(tileof.shape) != (B, TH * TW):
        raise ValueError(f"tileof must be int32 ({B}, {TH * TW}), got "
                         f"{tileof.dtype} {tuple(tileof.shape)}")
    if not (0 < H <= TH * tile and 0 < W <= TW * tile):
        raise ValueError(f"image {H}x{W} does not fit the {TH}x{TW} grid "
                         f"of tile {tile}")
    if tileof.device != rows.device:
        raise ValueError("rows and tileof must be on one device")
    if rows.device.type == "cpu":
        return untile_scatter_reference(rows, tileof, bg, image_size, tile,
                                        n_tiles_hw)
    if rows.element_size() not in (4, 8) or rows.is_complex() \
            or rows.dtype == torch.bool:
        raise ValueError(f"the untile kernel copies 4- or 8-byte values, "
                         f"got {rows.dtype}")
    if not tileof.is_contiguous():
        raise ValueError("the CUDA kernels take a contiguous tileof")
    out = rows.new_empty((B, H, W, C))        # the kernel writes every pixel
    if out.numel() == 0:
        return out
    sb, ss, sp, sc = rows.stride()
    launch("trt_untile_scatter", rows.data_ptr(), tileof.data_ptr(),
           _bg_bits(bg, rows.dtype), out.data_ptr(), rows.element_size(), B,
           H, W, C, tile, TH, TW, A, sb, ss, sp, sc, device=rows.device)
    UNTILE_LAUNCHES += 1
    return out


class UntileScatter(torch.autograd.Function):
    """untile_scatter as a differentiable op; the backward is the exact
    inverse in plain torch."""

    @staticmethod
    def forward(ctx, rows, tileof, bg, image_size, tile, n_tiles_hw):
        ctx.save_for_backward(tileof)
        ctx.params = (rows.shape[1], tile, n_tiles_hw)
        return untile_scatter_fwd(rows, tileof, bg, image_size, tile,
                                  n_tiles_hw)

    @staticmethod
    def backward(ctx, g):
        (tileof,) = ctx.saved_tensors
        A, tile, n_tiles_hw = ctx.params
        d_rows = compact_rows(tile_image(g, tile, n_tiles_hw), tileof, A)
        return d_rows, None, None, None, None, None


def untile_scatter(rows, tileof, bg, image_size, tile: int,
                   n_tiles_hw) -> torch.Tensor:
    """Compacted per-tile rows (B, A, tile^2, C) -> the cropped image
    (B, H, W, C) in one pass: tile t takes row tileof[b, t] when it is
    below A, else the scalar bg. Differentiable with respect to rows."""
    return UntileScatter.apply(rows, tileof, bg, image_size, tile,
                               n_tiles_hw)

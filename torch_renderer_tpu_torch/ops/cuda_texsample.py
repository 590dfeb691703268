"""Bilinear texture sampling through a hand-written CUDA kernel pair
(PyTorch counterpart of ``torch_renderer_tpu.ops.pallas_texsample``).

sample_bilinear(maps, y0, x0, wy, wx) reads, for each (view b, point p), the
four taps of maps (B, Hm, Wm, C) at rows y0, y0 + 1 and columns x0, x0 + 1
and blends them with the weights (1 - wy, wy) and (1 - wx, wx):

    top = c00 (1 - wx) + c01 wx,   bot = c10 (1 - wx) + c11 wx
    out = top (1 - wy) + bot wy                               -> (B, P, C)

Gradients flow to ``maps`` (each tap's weight times the cotangent, summed
into the texel: a scatter-add), to ``wy`` and to ``wx``; the integer corners
carry none, as in the JAX package's ``_sample_core``. Corners are clamped to
[0, Hm - 2] x [0, Wm - 2] by the kernels and the plain versions alike
(TexturesUV.sample already produces them in range).

The views may share one map: ``maps`` may be a batch broadcast (batch stride
0, e.g. ``texture_map[None].expand(B, ...)``), which the kernels index with
batch stride 0 instead of copying it. The map gradient comes back per view
(B, Hm, Wm, C), so autograd's expand backward sums the views.

For every kernel the module keeps its plain PyTorch version
(``texsample_fwd_reference``, ``texsample_bwd_reference``): a wrapper uses it
for a tensor on the CPU, launches the kernel for a CUDA tensor, and raises
for anything else.
"""

from __future__ import annotations

import functools
import struct

import torch

from .._build import check_launch, load_kernels, raw_stream

# Kernel launches since import (or since a caller reset them): one per
# launched kernel, counted where the wrapper launches it and nowhere else.
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the kernels
# ---------------------------------------------------------------------------

def _taps(maps, y0, x0):
    """The four taps (B, P, C) each and the flat index (B, P) of c00 into
    the (B * Hm * Wm) texel axis."""
    B, Hm, Wm, _ = maps.shape
    y = y0.long().clamp(0, Hm - 2)
    x = x0.long().clamp(0, Wm - 2)
    b = torch.arange(B, device=maps.device)[:, None]
    taps = (maps[b, y, x], maps[b, y, x + 1], maps[b, y + 1, x],
            maps[b, y + 1, x + 1])
    return taps, (b * Hm + y) * Wm + x


def texsample_fwd_reference(maps, y0, x0, wy, wx) -> torch.Tensor:
    """Plain version of the forward kernel: out (B, P, C)."""
    (c00, c01, c10, c11), _ = _taps(maps, y0, x0)
    wxe, wye = wx[..., None], wy[..., None]
    top = c00 * (1.0 - wxe) + c01 * wxe
    bot = c10 * (1.0 - wxe) + c11 * wxe
    return top * (1.0 - wye) + bot * wye


def texsample_bwd_reference(maps, y0, x0, wy, wx, g):
    """Plain version of the backward kernel: (d_maps (B, Hm, Wm, C), d_wy
    (B, P), d_wx (B, P)) for the cotangent g (B, P, C)."""
    B, Hm, Wm, C = maps.shape
    (c00, c01, c10, c11), base = _taps(maps, y0, x0)
    wxe, wye = wx[..., None], wy[..., None]
    ux, uy = 1.0 - wxe, 1.0 - wye
    d_wy = (g * ((c10 - c00) * ux + (c11 - c01) * wxe)).sum(-1)
    d_wx = (g * ((c01 - c00) * uy + (c11 - c10) * wye)).sum(-1)
    d_maps = maps.new_zeros((B * Hm * Wm, C))
    for off, w in ((0, uy * ux), (1, uy * wxe), (Wm, wye * ux),
                   (Wm + 1, wye * wxe)):
        d_maps.index_add_(0, (base + off).reshape(-1), (g * w).reshape(-1, C))
    return d_maps.reshape(B, Hm, Wm, C), d_wy, d_wx


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_F32, _I32 = torch.float32, torch.int32
# One launch's arguments in the C layout of csrc/texsample.cu's TexArgs:
# maps, map_stride, y0, x0, wy, wx, g, out (d_maps), d_wy, d_wx, stream, then
# B, P, Hm, Wm, C and the device index.
_ARGS = struct.Struct("@PqPPPPPPPPPiiiiii")


def _check_inputs(maps, y0, x0, wy, wx, g=None) -> tuple:
    """Validate the operands; returns (the map's batch stride in elements
    for the kernels (0 for a batch broadcast), the CUDA device's index (-1
    on the CPU), B, P, Hm, Wm, C). Each tensor's device, dtype and shape is
    read once, and devices are compared by index."""
    cuda = maps.is_cuda
    if not (cuda or maps.is_cpu):
        raise ValueError(f"no texture-sampling kernel for device {maps.device}")
    mshape = maps.shape
    if maps.dtype is not _F32 or len(mshape) != 4:
        raise ValueError(f"maps must be float32 (B, Hm, Wm, C), got "
                         f"{maps.dtype} {tuple(mshape)}")
    B, Hm, Wm, C = mshape
    if Hm < 2 or Wm < 2 or C < 1:
        raise ValueError(f"maps must be at least 2x2 with a channel, got "
                         f"{tuple(mshape)}")
    shape = y0.shape
    if len(shape) != 2 or shape[0] != B:
        raise ValueError(f"y0 must be (B={B}, P), got {tuple(shape)}")
    if not (y0.dtype is _I32 and x0.dtype is _I32 and wy.dtype is _F32
            and wx.dtype is _F32 and x0.shape == shape and wy.shape == shape
            and wx.shape == shape):
        shape = tuple(shape)
        for name, t, dt in (("y0", y0, _I32), ("x0", x0, _I32),
                            ("wy", wy, _F32), ("wx", wx, _F32)):
            if t.dtype != dt or tuple(t.shape) != shape:
                raise ValueError(f"{name} must be {dt} {shape}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
    if g is not None and (g.dtype is not _F32
                          or g.shape != (shape[0], shape[1], C)):
        raise ValueError(f"g must be float32 {tuple(shape) + (C,)}, got "
                         f"{g.dtype} {tuple(g.shape)}")
    if cuda:
        dev = maps.get_device()
        same = (y0.is_cuda and x0.is_cuda and wy.is_cuda and wx.is_cuda
                and y0.get_device() == dev and x0.get_device() == dev
                and wy.get_device() == dev and wx.get_device() == dev
                and (g is None or (g.is_cuda and g.get_device() == dev)))
    else:
        dev = -1
        same = (y0.is_cpu and x0.is_cpu and wy.is_cpu and wx.is_cpu
                and (g is None or g.is_cpu))
    if not same:
        raise ValueError("maps, y0, x0, wy, wx and g must be on one device")
    stride = _cuda_layout(maps, y0, x0, wy, wx, g) if cuda else Hm * Wm * C
    return stride, dev, B, shape[1], Hm, Wm, C


def _cuda_layout(maps, y0, x0, wy, wx, g=None) -> int:
    """The layout the CUDA kernels take (checked for any device, so that
    the CPU tests reach it): contiguous corners, weights and cotangent, and
    views of the map that are each contiguous, stacked or broadcast.
    Returns the map's batch stride in elements (0 for a broadcast)."""
    if not (y0.is_contiguous() and x0.is_contiguous()
            and wy.is_contiguous() and wx.is_contiguous()
            and (g is None or g.is_contiguous())):
        raise ValueError("the CUDA kernels take contiguous corner, "
                         "weight and cotangent tensors")
    B, Hm, Wm, C = maps.shape
    sb, sy, sx, sc = maps.stride()
    stride = Hm * Wm * C
    # maps[0] is contiguous: a channel axis of one may have any stride
    if sy != Wm * C or sx != C or (sc != 1 and C != 1) or (
            B > 1 and sb not in (0, stride)):
        raise ValueError("the CUDA kernels take a map whose views are "
                         "contiguous, stacked or broadcast (batch "
                         f"stride 0 or {stride}); got strides "
                         f"{maps.stride()}")
    return sb if B > 1 else stride


@functools.cache
def _kernels():
    """The kernel library, once its TexArgs is found to be _ARGS's size."""
    lib = load_kernels()
    if lib.trt_texsample_args_size() != _ARGS.size:
        raise RuntimeError(f"csrc/texsample.cu's TexArgs is "
                           f"{lib.trt_texsample_args_size()} bytes, the "
                           f"wrapper packs {_ARGS.size}")
    return lib


def texsample_fwd(maps, y0, x0, wy, wx) -> torch.Tensor:
    """Bilinear samples (B, P, C) of maps (B, Hm, Wm, C) at the int32
    corners y0, x0 (B, P) with the float32 weights wy, wx (B, P)."""
    global FWD_LAUNCHES
    stride, dev, B, P, Hm, Wm, C = _check_inputs(maps, y0, x0, wy, wx)
    if dev < 0:
        return texsample_fwd_reference(maps, y0, x0, wy, wx)
    out = maps.new_empty((B, P, C))           # the kernel writes every point
    if B * P == 0:
        return out
    check_launch("trt_texsample_fwd", _kernels().trt_texsample_fwd(_ARGS.pack(
        maps.data_ptr(), stride, y0.data_ptr(), x0.data_ptr(), wy.data_ptr(),
        wx.data_ptr(), 0, out.data_ptr(), 0, 0, raw_stream(dev), B, P, Hm,
        Wm, C, dev)))
    FWD_LAUNCHES += 1
    return out


def texsample_bwd(maps, y0, x0, wy, wx, g):
    """(d_maps (B, Hm, Wm, C), d_wy (B, P), d_wx (B, P)) of the samples
    contracted with the cotangent g (B, P, C). On the card d_maps is summed
    with float32 atomics, so its summation order varies from run to run."""
    global BWD_LAUNCHES
    stride, dev, B, P, Hm, Wm, C = _check_inputs(maps, y0, x0, wy, wx, g)
    if dev < 0:
        return texsample_bwd_reference(maps, y0, x0, wy, wx, g)
    d_maps = maps.new_zeros((B, Hm, Wm, C))   # the kernel adds into it
    d_wy = wy.new_empty((B, P))               # the kernel writes every point
    d_wx = wx.new_empty((B, P))
    if B * P == 0:
        return d_maps, d_wy, d_wx
    check_launch("trt_texsample_bwd", _kernels().trt_texsample_bwd(_ARGS.pack(
        maps.data_ptr(), stride, y0.data_ptr(), x0.data_ptr(), wy.data_ptr(),
        wx.data_ptr(), g.data_ptr(), d_maps.data_ptr(), d_wy.data_ptr(),
        d_wx.data_ptr(), raw_stream(dev), B, P, Hm, Wm, C, dev)))
    BWD_LAUNCHES += 1
    return d_maps, d_wy, d_wx


class TexSample(torch.autograd.Function):
    """The kernel pair as one differentiable op: (maps, wy, wx) -> samples;
    the corners y0, x0 get no gradient."""

    @staticmethod
    def forward(ctx, maps, y0, x0, wy, wx):
        ctx.save_for_backward(maps, y0, x0, wy, wx)
        return texsample_fwd(maps, y0, x0, wy, wx)

    @staticmethod
    def backward(ctx, g):
        maps, y0, x0, wy, wx = ctx.saved_tensors
        d_maps, d_wy, d_wx = texsample_bwd(maps, y0, x0, wy, wx,
                                           g.contiguous())
        need = ctx.needs_input_grad
        return (d_maps if need[0] else None, None, None,
                d_wy if need[3] else None, d_wx if need[4] else None)


def sample_bilinear(maps, y0, x0, wy, wx) -> torch.Tensor:
    """Bilinear sample maps (B, Hm, Wm, C) at integer corners y0/x0 (int32)
    with weights wy/wx, each (B, P) -> (B, P, C); the counterpart of
    ``sample_bilinear_pallas``. Differentiable with respect to maps and the
    weights."""
    return TexSample.apply(maps, y0, x0, wy, wx)

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

import torch

from .._build import launch

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

def _check_inputs(maps, y0, x0, wy, wx, g=None) -> int:
    """Validate the operands; returns the map's batch stride in elements
    for the kernels (0 for a batch broadcast)."""
    if maps.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no texture-sampling kernel for device {maps.device}")
    if maps.dtype != torch.float32 or maps.ndim != 4:
        raise ValueError(f"maps must be float32 (B, Hm, Wm, C), got "
                         f"{maps.dtype} {tuple(maps.shape)}")
    B, Hm, Wm, C = maps.shape
    if Hm < 2 or Wm < 2 or C < 1:
        raise ValueError(f"maps must be at least 2x2 with a channel, got "
                         f"{tuple(maps.shape)}")
    if y0.ndim != 2 or y0.shape[0] != B:
        raise ValueError(f"y0 must be (B={B}, P), got {tuple(y0.shape)}")
    shape = tuple(y0.shape)
    for name, t, dt in (("y0", y0, torch.int32), ("x0", x0, torch.int32),
                        ("wy", wy, torch.float32), ("wx", wx, torch.float32)):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if g is not None and (g.dtype != torch.float32
                          or tuple(g.shape) != shape + (C,)):
        raise ValueError(f"g must be float32 {shape + (C,)}, got {g.dtype} "
                         f"{tuple(g.shape)}")
    tensors = (maps, y0, x0, wy, wx) + (() if g is None else (g,))
    if any(t.device != maps.device for t in tensors):
        raise ValueError("maps, y0, x0, wy, wx and g must be on one device")
    stride = Hm * Wm * C
    if maps.device.type == "cuda":
        if not all(t.is_contiguous() for t in tensors[1:]):
            raise ValueError("the CUDA kernels take contiguous corner, "
                             "weight and cotangent tensors")
        if not maps[0].is_contiguous() or (
                B > 1 and maps.stride(0) not in (0, stride)):
            raise ValueError("the CUDA kernels take a map whose views are "
                             "contiguous, stacked or broadcast (batch "
                             f"stride 0 or {stride}); got strides "
                             f"{maps.stride()}")
        if B > 1:
            stride = maps.stride(0)
    return stride


def texsample_fwd(maps, y0, x0, wy, wx) -> torch.Tensor:
    """Bilinear samples (B, P, C) of maps (B, Hm, Wm, C) at the int32
    corners y0, x0 (B, P) with the float32 weights wy, wx (B, P)."""
    global FWD_LAUNCHES
    stride = _check_inputs(maps, y0, x0, wy, wx)
    if maps.device.type == "cpu":
        return texsample_fwd_reference(maps, y0, x0, wy, wx)
    B, Hm, Wm, C = maps.shape
    P = y0.shape[1]
    out = maps.new_empty((B, P, C))           # the kernel writes every point
    if B * P == 0:
        return out
    launch("trt_texsample_fwd", maps.data_ptr(), stride, y0.data_ptr(),
           x0.data_ptr(), wy.data_ptr(), wx.data_ptr(), out.data_ptr(), B, P,
           Hm, Wm, C, device=maps.device)
    FWD_LAUNCHES += 1
    return out


def texsample_bwd(maps, y0, x0, wy, wx, g):
    """(d_maps (B, Hm, Wm, C), d_wy (B, P), d_wx (B, P)) of the samples
    contracted with the cotangent g (B, P, C). On the card d_maps is summed
    with float32 atomics, so its summation order varies from run to run."""
    global BWD_LAUNCHES
    stride = _check_inputs(maps, y0, x0, wy, wx, g)
    if maps.device.type == "cpu":
        return texsample_bwd_reference(maps, y0, x0, wy, wx, g)
    B, Hm, Wm, C = maps.shape
    P = y0.shape[1]
    d_maps = maps.new_zeros((B, Hm, Wm, C))   # the kernel adds into it
    d_wy = wy.new_empty((B, P))               # the kernel writes every point
    d_wx = wx.new_empty((B, P))
    if B * P == 0:
        return d_maps, d_wy, d_wx
    launch("trt_texsample_bwd", maps.data_ptr(), stride, y0.data_ptr(),
           x0.data_ptr(), wy.data_ptr(), wx.data_ptr(), g.data_ptr(),
           d_maps.data_ptr(), d_wy.data_ptr(), d_wx.data_ptr(), B, P, Hm, Wm,
           C, device=maps.device)
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

"""Fragment blending: hard z-buffer and SoftRas sigmoid / softmax blending
(PyTorch counterpart of ``torch_renderer_tpu.shading.blending``, itself
pytorch3d's BlendParams / hard_rgb_blend / softmax_rgb_blend)."""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from ..rasterize.fragments import Fragments


@dataclasses.dataclass(frozen=True)
class BlendParams:
    """sigma: edge softness (sigmoid of the signed squared distance);
    gamma: the z-softmax temperature."""

    sigma: float = 1e-4
    gamma: float = 1e-4
    background_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) without torch's linear cut-off above 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


def sigmoid_alpha(fragments: Fragments, sigma: float) -> torch.Tensor:
    """SoftRas coverage (B, H, W): 1 - prod_k (1 - sigmoid(-dist_k / sigma)),
    in log space: 1 - exp(-sum_k softplus(-dist_k / sigma))."""
    terms = _softplus(-fragments.dists / sigma) * fragments.mask
    return 1.0 - torch.exp(-terms.sum(-1))


@functools.lru_cache(maxsize=16)
def background(color: tuple, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """The background color as a (3,) tensor on device, made once by fills
    (no host-to-device copy, which a captured step cannot hold) and shared
    by every blend; callers do not write to it."""
    bg = torch.empty(len(color), dtype=dtype, device=device)
    for i, c in enumerate(color):
        bg[i].fill_(c)
    return bg


def hard_rgb_blend(colors: torch.Tensor, fragments: Fragments,
                   blend: BlendParams) -> torch.Tensor:
    """Nearest-fragment color with background fill: (B, H, W, K, 3) ->
    RGBA (B, H, W, 4)."""
    bg = background(tuple(blend.background_color), colors.dtype, colors.device)
    m = fragments.mask[..., 0:1]
    rgb = torch.where(m, colors[..., 0, :], bg)
    return torch.cat([rgb, m.to(colors.dtype)], dim=-1)


def softmax_rgb_blend(colors: torch.Tensor, fragments: Fragments,
                      blend: BlendParams, znear: float = 1.0,
                      zfar: float = 100.0) -> torch.Tensor:
    """SoftRas aggregation (pytorch3d's softmax_rgb_blend): colors
    (B, H, W, Kc, 3), Kc <= K (the color softmax then runs over the nearest
    Kc slots while alpha keeps all K) -> RGBA (B, H, W, 4)."""
    eps = 1e-10
    kc = colors.shape[-2]
    mask = fragments.mask[..., :kc]
    prob = torch.sigmoid(-fragments.dists[..., :kc] / blend.sigma) * mask
    zinv = (zfar - fragments.zbuf[..., :kc]) / (zfar - znear) * mask
    zmax = zinv.amax(-1, keepdim=True)                       # stabilizer
    w = prob * torch.exp((zinv - zmax) / blend.gamma)
    delta = torch.exp((eps - zmax[..., 0]) / blend.gamma)
    denom = w.sum(-1) + delta
    bg = background(tuple(blend.background_color), colors.dtype, colors.device)
    rgb = (torch.einsum("...k,...kc->...c", w, colors)
           + delta[..., None] * bg) / denom[..., None]
    alpha = sigmoid_alpha(fragments, blend.sigma)
    return torch.cat([rgb, alpha[..., None]], dim=-1)

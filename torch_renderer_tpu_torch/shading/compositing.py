"""Point-splat compositing: alpha, norm-weighted and Pulsar-style blending
(PyTorch counterpart of ``torch_renderer_tpu.shading.compositing``).

pytorch3d's AlphaCompositor and NormWeightedCompositor, a softmax depth
blend of 2D splats, and the sphere-based Pulsar blend (Lassner &
Zollhoefer, CVPR 2021). All work on PointFragments and per-splat features
over the small K axis.
"""

from __future__ import annotations

import torch

from .._device import scalar_tensor
from ..rasterize.points import PointFragments
from ..structures.pointclouds import Pointclouds

INF_Z = 1e10


def _gather_hits(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr (B, N, C) rows at idx (B, ...) -> (B, ..., C); idx >= 0."""
    B, C = arr.shape[0], arr.shape[-1]
    g = arr.gather(1, idx.reshape(B, -1, 1).expand(-1, -1, C))
    return g.reshape(idx.shape + (C,))


def gather_point_features(pcls: Pointclouds, fragments: PointFragments,
                          default: float = 1.0) -> torch.Tensor:
    """Per-splat features (B, H, W, K, C) gathered from pcls.features
    (``default`` in 3 channels if the cloud has none), 0 at empty slots."""
    if pcls.features is None:
        B, N = pcls.points.shape[:2]
        feats = torch.full((B, N, 3), default, dtype=torch.float32,
                           device=pcls.points.device)
    else:
        feats = pcls.features
    g = _gather_hits(feats, fragments.idx.clamp_min(0))
    return torch.where(fragments.mask[..., None], g, 0.0)


def splat_weights(fragments: PointFragments, radius) -> torch.Tensor:
    """pytorch3d splat weight w = 1 - d^2 / r^2 clipped to [0, 1], 0 at
    empty slots. radius: a scalar, or a tensor broadcastable to
    fragments.dists2 (the per-hit radius the splats were selected with)."""
    radius = scalar_tensor(radius, torch.float32, fragments.dists2.device)
    if radius.ndim:                    # dead slots carry a 0 per-hit radius
        radius = torch.where(fragments.mask, radius, 1.0)
    w = 1.0 - fragments.dists2 / (radius * radius)
    return torch.where(fragments.mask, w.clamp(0.0, 1.0), 0.0)


def _exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    """prod_{j<k} x_j along the last dim (1 at k = 0) by sequential
    products, the order torch.cumprod multiplies in on the CPU. Its
    backward is the product rule's and reads nothing back to the host:
    torch.cumprod's backward asks the host whether an input is 0 (a
    saturated splat's 1 - w is), which a captured CUDA graph cannot do."""
    out = [torch.ones_like(x[..., 0])]
    for k in range(x.shape[-1] - 1):
        out.append(out[-1] * x[..., k])
    return torch.stack(out, dim=-1)


def alpha_composite(weights: torch.Tensor,
                    features: torch.Tensor) -> torch.Tensor:
    """Front-to-back over-compositing (AlphaCompositor parity): weights
    (B, H, W, K) nearest first, features (B, H, W, K, C) ->
    (B, H, W, C + 1) with the accumulated alpha last.
    out_c = sum_k w_k prod_{j<k} (1 - w_j) c_k."""
    contrib = weights * _exclusive_cumprod(1.0 - weights)
    rgb = torch.einsum("...k,...kc->...c", contrib, features)
    return torch.cat([rgb, contrib.sum(-1, keepdim=True)], dim=-1)


def norm_weighted_composite(weights: torch.Tensor, features: torch.Tensor,
                            eps: float = 1e-10) -> torch.Tensor:
    """Normalized weighted sum (NormWeightedCompositor parity) ->
    (B, H, W, C + 1)."""
    denom = weights.sum(-1, keepdim=True)
    rgb = torch.einsum("...k,...kc->...c", weights, features) \
        / denom.clamp_min(eps)
    return torch.cat([rgb, denom.clamp(0.0, 1.0)], dim=-1)


def pulsar_composite(fragments: PointFragments, weights: torch.Tensor,
                     features: torch.Tensor, gamma: float = 1e-3,
                     background: float = 0.0,
                     eps: float = 1e-10) -> torch.Tensor:
    """2D splats blended by a softmax over center depth with temperature
    gamma (small gamma: the nearest splat wins; large: a translucent mix).
    Returns (B, H, W, C + 1)."""
    mask = fragments.mask
    z = torch.where(mask, fragments.zbuf, INF_Z)
    zmin = z.amin(-1, keepdim=True)
    depth_w = torch.exp(-(z - zmin) / gamma) * mask
    w = weights * depth_w
    denom = w.sum(-1, keepdim=True)
    wsum = weights.sum(-1, keepdim=True)
    rgb = (torch.einsum("...k,...kc->...c", w, features)
           + background * torch.exp(-wsum)) / denom.clamp_min(eps)
    return torch.cat([rgb, 1.0 - torch.exp(-wsum)], dim=-1)


def _safe_sqrt(x: torch.Tensor, floor: float) -> torch.Tensor:
    """sqrt(x) where x > floor, else 0, with a finite gradient everywhere
    (the double where: sqrt'(0) = inf times 0 would be NaN)."""
    ok = x > floor
    return torch.where(ok, torch.sqrt(torch.where(ok, x, 1.0)), 0.0)


def pulsar_sphere_composite(
    fragments: PointFragments, centers_cam: torch.Tensor,
    radius_world: torch.Tensor, opacity: torch.Tensor,
    features: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
    cx: torch.Tensor, cy: torch.Tensor, image_size, gamma: float = 1e-2,
    znear: float = 0.1, zfar: float = 10.0, background: float = 0.0,
    eps: float = 1e-3, packed_hit_channels=None,
) -> torch.Tensor:
    """Sphere-based Pulsar blending. Each splat is a sphere (camera-space
    center, world radius, opacity in [0, 1]); per pixel ray the K selected
    spheres are intersected analytically and blended with weight

        w_i  proportional to  o_i d_i exp(o_i zhat_i / gamma)

    against the background's exp(eps / gamma), where zhat_i in [0, 1] is
    the normalized ray-sphere intersection depth over [znear, zfar] (1 =
    nearest) and d_i a one-pixel linear ramp at the sphere's silhouette,
    which carries gradients to positions and radii.

    centers_cam (B, N, 3); radius_world, opacity (B, N); features (B, N, C);
    fx, fy, cx, cy (B,). packed_hit_channels: the binned path's per-hit
    [center xyz, radius, opacity, features] (B, H, W, K, 5 + C), in place
    of gathering them here. Returns (B, H, W, C + 1), alpha = 1 - w_bg."""
    H, W = image_size
    B = fragments.idx.shape[0]
    if packed_hit_channels is not None:
        hc = packed_hit_channels
        c, r, o, f = hc[..., :3], hc[..., 3], hc[..., 4], hc[..., 5:]
    else:
        safe = fragments.idx.clamp_min(0)
        c = _gather_hits(centers_cam, safe)
        r = _gather_hits(radius_world[..., None], safe)[..., 0]
        o = _gather_hits(opacity[..., None], safe)[..., 0]
        f = _gather_hits(features, safe)

    dev = centers_cam.device
    u = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5)[None, None]
    v = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5)[None, :,
                                                                 None]
    dx = ((u - cx[:, None, None]) / fx[:, None, None]).expand(B, H, W)
    dy = ((v - cy[:, None, None]) / fy[:, None, None]).expand(B, H, W)
    dn = torch.sqrt(dx * dx + dy * dy + 1.0)
    d = torch.stack([dx, dy, torch.ones_like(dx)], dim=-1) / dn[..., None]

    # ray-sphere geometry: t_c closest approach, b orthogonal distance
    t_c = (c * d[:, :, :, None, :]).sum(-1)                  # (B, H, W, K)
    b2 = ((c * c).sum(-1) - t_c * t_c).clamp_min(0.0)
    disc = r * r - b2
    hit = fragments.mask & (disc > 0.0) & (t_c > 0.0)
    t_int = t_c - _safe_sqrt(disc, 0.0)
    b = _safe_sqrt(b2, 1e-12)
    z_int = t_int * d[:, :, :, None, 2]                       # camera depth

    zhat = ((zfar - z_int) / (zfar - znear)).clamp(0.0, 1.0)
    fpx = z_int.clamp_min(znear) / torch.maximum(fx, fy)[:, None, None, None]
    d_cov = ((r - b) / fpx.clamp_min(1e-12)).clamp(0.0, 1.0)

    logit = torch.where(hit, o * zhat / gamma, -INF_Z)
    l_bg = eps / gamma
    m = logit.amax(-1).clamp_min(l_bg)                        # (B, H, W)
    e = torch.where(hit, o * d_cov * torch.exp(logit - m[..., None]), 0.0)
    e_bg = torch.exp(l_bg - m)
    denom = e.sum(-1) + e_bg
    rgb = (torch.einsum("...k,...kc->...c", e, f)
           + e_bg[..., None] * background) / denom[..., None]
    return torch.cat([rgb, (1.0 - e_bg / denom)[..., None]], dim=-1)

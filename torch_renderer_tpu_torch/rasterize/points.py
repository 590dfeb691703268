"""Point-cloud rasterization into per-pixel top-K point splats (PyTorch
counterpart of ``torch_renderer_tpu.rasterize.points``).

Two passes, as in the mesh rasterizer (rasterize/raster.py):

  1. SELECTION (not differentiable): the K nearest-in-z points whose splat
     (a disc of NDC radius r around the projected center) covers each
     pixel. Binned settings (bin_size > 0) run the points_select CUDA
     kernel of rasterize/cuda_points.py (its plain PyTorch version on a
     CPU tensor); bin_size 0 runs the dense selection below in plain torch
     (the matmul expansion of the squared distance, then K argmin passes).
  2. RECOMPUTATION (differentiable): z and the squared distance of the
     selected points only, from their gathered centers, so gradients reach
     the points through this pass.

Raster space is pytorch3d's non-square NDC (the shorter side spans
[-1, 1]), so ``radius`` carries over from pytorch3d's
PointsRasterizationSettings.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple, Union

import torch

from ..cameras.perspective import PerspectiveCamera
from ..structures.pointclouds import Pointclouds
from .soft import pixel_coords_raster

INF = 3.0e38


@dataclasses.dataclass(frozen=True)
class PointFragments:
    """Per-pixel top-K point hits (pytorch3d PointFragments parity).

    idx:    (B, H, W, K) int64 point index, -1 = empty, nearest first.
    zbuf:   (B, H, W, K) camera z of the point, -1 where empty.
    dists2: (B, H, W, K) squared pixel-to-center distance in NDC, -1 where
        empty.
    features: optional (B, H, W, K, C) per-hit point channels, 0 where
        empty: the binned path returns the ``extra`` channels of each
        winner here (the dense path leaves it None).
    """

    idx: torch.Tensor
    zbuf: torch.Tensor
    dists2: torch.Tensor
    features: Optional[torch.Tensor] = None

    @property
    def mask(self) -> torch.Tensor:
        return self.idx >= 0


@dataclasses.dataclass(frozen=True)
class PointsRasterizationSettings:
    """Mirror of pytorch3d's PointsRasterizationSettings (radius in NDC
    units), with every field of the JAX package's settings.

    bin_size: None = auto (rasterize/autotune.py measures tile and budgets
    from the first concrete cloud per shape), 0 = dense selection, k > 0 =
    binned with tile k (any k, any points_per_pixel): points are binned
    into k-pixel tiles by their radius-expanded bbox and each tile
    evaluates its own candidates.
    Points beyond a tile's max_points_per_bin and non-empty tiles beyond
    active_tiles are dropped; size them with suggest_points_per_bin and
    suggest_active_tiles_points.

    impl: "auto", "xla" and "pallas" are accepted and select nothing: every
    binned call runs the points_select kernel on a CUDA tensor. Another
    value raises on the binned path, as in the JAX package.

    check_budgets: None (the process default), "off" or "warn".
    """

    image_size: Tuple[int, int]
    radius: float = 0.01
    points_per_pixel: int = 8
    znear: float = 1e-5
    pixel_chunk: int = 8192
    bin_size: Union[None, int] = None
    max_points_per_bin: int = 128
    impl: str = "auto"
    active_tiles: Union[None, int] = None
    check_budgets: Union[None, str] = None


def project_points_screen(pcls: Pointclouds, camera: PerspectiveCamera,
                          znear: float):
    """(B, N, 2) raster coords, (B, N) camera z, (B, N) bool valid."""
    H, W = camera.image_size
    s = camera.ndc_scale
    uv, z = camera.project(camera.world_to_camera(pcls.points))
    q = torch.stack([(uv[..., 0] - W / 2.0) / s,
                     (uv[..., 1] - H / 2.0) / s], dim=-1)
    valid = (pcls.mask() > 0) & (z > znear)
    return q, z, valid


def _radius_array(radius, default: float, B: int, N: int, device):
    """(B, N) float32 per-point radii: the override, else the default."""
    r = default if radius is None else radius
    return torch.as_tensor(r, dtype=torch.float32, device=device).expand(
        B, N)


def _select_chunk(pix, q, z, valid, radius2, K: int) -> torch.Tensor:
    """Top-K nearest-in-z covering points of one pixel chunk of one cloud:
    pix (P, 2), q (N, 2), z, valid, radius2 (N,) -> (P, K) int64 point
    ids, -1 where fewer than K points cover, ties to the lower id."""
    pp = (pix * pix).sum(-1)
    qq = (q * q).sum(-1)
    d2 = (pp[:, None] + qq[None, :] - 2.0 * (pix @ q.T)).clamp_min(0.0)
    cover = (d2 <= radius2[None, :]) & valid[None, :]
    priority = torch.where(cover, z[None, :], torch.full_like(d2, INF))
    del d2, cover
    k_eff = min(K, priority.shape[-1])
    out = []
    for _ in range(k_eff):            # argmin passes: ties to the first id
        idx = priority.argmin(-1, keepdim=True)
        zmin = priority.gather(-1, idx)
        out.append(torch.where(zmin < INF, idx, -1))
        priority.scatter_(-1, idx, INF)
    out = torch.cat(out, dim=-1)
    if k_eff < K:
        out = torch.nn.functional.pad(out, (0, K - k_eff), value=-1)
    return out


def _rasterize_points_dense(q, z, valid, radius2,
                            settings: PointsRasterizationSettings
                            ) -> PointFragments:
    H, W = settings.image_size
    K = settings.points_per_pixel
    B = z.shape[0]
    pix_all = pixel_coords_raster((H, W), q.device)           # (HW, 2)
    HW = pix_all.shape[0]
    with torch.no_grad():
        idx = torch.stack([
            torch.cat([_select_chunk(pix_all[p0:p0 + settings.pixel_chunk],
                                     q[b], z[b], valid[b], radius2[b], K)
                       for p0 in range(0, HW, settings.pixel_chunk)])
            for b in range(B)])                               # (B, HW, K)

    safe = idx.clamp_min(0).reshape(B, HW * K)
    qg = q.gather(1, safe[..., None].expand(B, HW * K, 2))
    zg = z.gather(1, safe).reshape(B, HW, K)
    diff = pix_all[None, :, None, :] - qg.reshape(B, HW, K, 2)
    d2 = (diff * diff).sum(-1)
    live = idx >= 0
    shape = lambda a: a.reshape((B, H, W) + a.shape[2:])       # noqa: E731
    return PointFragments(idx=shape(idx),
                          zbuf=shape(torch.where(live, zg, -1.0)),
                          dists2=shape(torch.where(live, d2, -1.0)))


def rasterize_points(pcls: Pointclouds, camera: PerspectiveCamera,
                     settings: PointsRasterizationSettings,
                     radius=None, extra=None) -> PointFragments:
    """Rasterize point clouds into per-pixel top-K PointFragments.

    radius: optional per-point (B, N) NDC radius override (the sphere
    renderer's selection radii); default settings.radius for all points.
    extra: optional (B, N, C) per-point channels returned per hit on
    PointFragments.features by the binned path (the dense path ignores
    them).
    """
    q, z, valid = project_points_screen(pcls, camera, settings.znear)
    B, N = z.shape
    radius_arr = _radius_array(radius, settings.radius, B, N, q.device)
    uniform_r2 = None if radius is not None else float(settings.radius) ** 2
    radius2 = radius_arr * radius_arr

    from .autotune import resolve_points_settings

    settings = resolve_points_settings(settings, q=q, z=z, valid=valid,
                                       radius_arr=radius_arr)
    if settings.bin_size:
        from .cuda_points import rasterize_points_binned_cuda

        return rasterize_points_binned_cuda(q, z, valid, radius2, settings,
                                            extra=extra,
                                            uniform_r2=uniform_r2)
    if settings.impl == "pallas":
        warnings.warn(
            "impl='pallas' resolved to the DENSE point path (bin_size 0 or "
            "auto below the binning thresholds); the point-selection kernel "
            "only runs binned, so this renders with the dense selection. "
            "Pass an explicit bin_size to force binning.", RuntimeWarning,
            stacklevel=2)
    return _rasterize_points_dense(q, z, valid, radius2, settings)


def _bbox_args(pcls, camera, settings, radius):
    """Radius-expanded bboxes and validity of a concrete cloud, detached."""
    with torch.no_grad():
        q, z, valid = project_points_screen(pcls, camera, settings.znear)
        r = _radius_array(radius, settings.radius, *z.shape, q.device)
        return q - r[..., None], q + r[..., None], valid


def suggest_points_per_bin(pcls: Pointclouds, camera: PerspectiveCamera,
                           settings: PointsRasterizationSettings,
                           radius=None, margin: float = 1.3,
                           multiple: int = 32) -> int:
    """Smallest safe max_points_per_bin for this cloud and camera, with
    head-room (overflowing tiles drop points). Reads a count back to the
    host: call at set-up."""
    import math

    from .binning import count_bbox_overflow

    if not settings.bin_size:
        raise ValueError(
            "suggest_points_per_bin needs settings.bin_size (the budget is "
            "per tile; sizing for one tile and rendering at another would "
            "overflow and drop points)")
    lo, hi, valid = _bbox_args(pcls, camera, settings, radius)
    mx = count_bbox_overflow(lo, hi, valid, settings.image_size,
                             settings.bin_size)
    want = int(math.ceil(float(mx) * margin / multiple)) * multiple
    return max(multiple, min(want, valid.shape[1]))


def suggest_active_tiles_points(pcls: Pointclouds, camera: PerspectiveCamera,
                                settings: PointsRasterizationSettings,
                                radius=None, margin: float = 1.5,
                                multiple: int = 8) -> int:
    """Smallest safe active-tile budget for this cloud and camera (the
    largest non-empty tile count of the batch, with head-room; tiles beyond
    it are dropped). Reads a count back to the host: call at set-up."""
    import math

    from .binning import count_bbox_active_tiles, tile_grid

    if not settings.bin_size:
        raise ValueError("suggest_active_tiles_points needs settings.bin_size")
    lo, hi, valid = _bbox_args(pcls, camera, settings, radius)
    n = count_bbox_active_tiles(lo, hi, valid, settings.image_size,
                                settings.bin_size)
    TH, TW, _ = tile_grid(settings.image_size, settings.bin_size)
    want = int(math.ceil(n * margin / multiple)) * multiple
    return max(multiple, min(want, TH * TW))

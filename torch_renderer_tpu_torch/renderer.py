"""High-level mesh and point-cloud renderers (PyTorch counterpart of
``torch_renderer_tpu.renderer``).

Each mesh renderer rasterizes once and derives every requested output
(depth, soft silhouette, soft-Phong RGB) from the shared fragments; each
point renderer rasterizes point splats once and composites them. ``render``
methods take OpenCV (R, tvec) extrinsics directly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ._device import resolve_device, scalar_tensor
from .cameras.perspective import PerspectiveCamera, _as_batched
from .rasterize.fragments import Fragments
from .rasterize.points import PointsRasterizationSettings, rasterize_points
from .rasterize.raster import RasterizationSettings, rasterize_meshes
from .shading.blending import BlendParams, sigmoid_alpha
from .shading.compositing import (
    alpha_composite,
    gather_point_features,
    norm_weighted_composite,
    pulsar_composite,
    pulsar_sphere_composite,
    splat_weights,
)
from .shading.lights import Materials, PointLights
from .shading.phong import hard_phong_shader, soft_phong_shader
from .structures.meshes import Meshes
from .structures.pointclouds import Pointclouds


@dataclasses.dataclass(frozen=True)
class RenderOutputs:
    """Everything a pose or shape fitting step needs, from one
    rasterization."""

    depth: torch.Tensor                    # (B, H, W), background 0
    zbuf: torch.Tensor                     # (B, H, W), background -1
    silhouette: Optional[torch.Tensor]     # (B, H, W) soft coverage in [0, 1]
    rgb: Optional[torch.Tensor]            # (B, H, W, 3)
    fragments: Fragments


class DifferentiableRenderer:
    """Base: OpenCV pinhole K ((3, 3) or (B, 3, 3)) and an (H, W) tuple,
    on ``device``: by default K's device when K is a tensor, else the
    current CUDA device (RuntimeError without one; pass device="cpu" for
    the CPU)."""

    def __init__(self, K, image_size: Tuple[int, int], device=None):
        if not isinstance(image_size, tuple):
            raise ValueError("image_size must be a tuple, e.g. (720, 1280)")
        K_t = _as_batched(K, 2, resolve_device(device, like=K))
        if K_t.shape[-2:] != (3, 3) or K_t.ndim != 3:
            raise ValueError(f"K must be (3, 3) or (B, 3, 3), got "
                             f"{tuple(torch.as_tensor(K).shape)}")
        self._image_size = (int(image_size[0]), int(image_size[1]))
        self._base_camera = PerspectiveCamera.from_K(K_t, self._image_size)

    @property
    def device(self) -> torch.device:
        return self._base_camera.fx.device

    def camera_with_pose(self, R, tvec) -> PerspectiveCamera:
        return self._base_camera.replace_pose(R, tvec)

    @property
    def image_size(self):
        return self._image_size


class MeshRenderer(DifferentiableRenderer):
    """One-rasterization multi-output mesh renderer.

    bin_size follows pytorch3d's contract (None = auto, 0 = dense, k > 0 =
    explicit; see RasterizationSettings). shade_k shades only the nearest
    shade_k fragment slots for RGB. The background is (0, 0, 0), unlike
    BlendParams' default.

    recon_points is accepted and does nothing: in the JAX package it makes
    the bin-local shading branch rebuild world positions from camera rays,
    and the port shades by global interpolation only (as the JAX package's
    CPU path, which never takes that branch, does)."""

    def __init__(
        self, K, image_size: Tuple[int, int], blur_radius: float = 0.0,
        faces_per_pixel: int = 1, sigma: float = 1e-4, gamma: float = 1e-4,
        background_color=(0.0, 0.0, 0.0),
        lights: Optional[PointLights] = None,
        materials: Optional[Materials] = None, pixel_chunk: int = 8192,
        bin_size: Optional[int] = None, max_faces_per_bin: int = 128,
        impl: str = "auto", shade_k: Optional[int] = None,
        active_tiles: Optional[int] = None, layout: str = "tile",
        group_lanes: Optional[int] = None,
        occupancy_split: Optional[Tuple[int, int]] = None,
        select_impl: str = "auto", untile_impl: str = "xla",
        recon_points: bool = False, check_budgets: Optional[str] = None,
        device=None,
    ):
        super().__init__(K, image_size, device)
        self.shade_k = shade_k
        self.recon_points = recon_points
        self.settings = RasterizationSettings(
            image_size=self._image_size, blur_radius=blur_radius,
            faces_per_pixel=faces_per_pixel, pixel_chunk=pixel_chunk,
            bin_size=bin_size, max_faces_per_bin=max_faces_per_bin,
            impl=impl, active_tiles=active_tiles, layout=layout,
            group_lanes=group_lanes, occupancy_split=occupancy_split,
            select_impl=select_impl, untile_impl=untile_impl,
            check_budgets=check_budgets,
        )
        self.blend = BlendParams(sigma=sigma, gamma=gamma,
                                 background_color=background_color)
        self.lights = (lights if lights is not None
                       else PointLights.make(device=self.device))
        self.materials = (materials if materials is not None
                          else Materials.make(device=self.device))

    def resolved_settings(self, meshes: Meshes, R, tvec, grow=False,
                          margin=None) -> RasterizationSettings:
        """The concrete settings this scene rasterizes with: auto
        (bin_size=None) resolves through rasterize.autotune (cached per
        shape); explicit settings pass through."""
        if self.settings.bin_size is not None:
            return self.settings
        from .rasterize.autotune import resolve_mesh_settings

        return resolve_mesh_settings(
            self.settings, meshes, self.camera_with_pose(R, tvec),
            grow=grow, margin=margin)

    def prepare(self, meshes: Meshes, R, tvec, grow=False,
                margin=None) -> RasterizationSettings:
        """Resolve auto settings at set-up, so no later render reads counts
        back. margin overrides the 1.5x head-room (pose fits use 2.0);
        grow=True widens an existing cached resolution."""
        return self.resolved_settings(meshes, R, tvec, grow=grow,
                                      margin=margin)

    def rasterize(self, meshes: Meshes, R, tvec):
        cam = self.camera_with_pose(R, tvec)
        return rasterize_meshes(meshes, cam, self.settings), cam

    def render(self, meshes: Meshes, R, tvec, *, with_silhouette: bool = True,
               with_rgb: bool = False, soft_rgb: bool = True) -> RenderOutputs:
        frags, cam = self.rasterize(meshes, R, tvec)
        sil = sigmoid_alpha(frags, self.blend.sigma) if with_silhouette \
            else None
        rgb = None
        if with_rgb:
            if soft_rgb:
                rgba = soft_phong_shader(meshes, frags, cam, self.lights,
                                         self.materials, self.blend,
                                         shade_k=self.shade_k)
            else:
                rgba = hard_phong_shader(meshes, frags, cam, self.lights,
                                         self.materials, self.blend)
            rgb = rgba[..., :3]
        return RenderOutputs(depth=frags.depth(), zbuf=frags.zbuf[..., 0],
                             silhouette=sil, rgb=rgb, fragments=frags)


class DepthRender(MeshRenderer):
    """Depth (+ optional soft silhouette) from one rasterization."""

    def __init__(self, K, image_size, faces_per_pixel: int = 1, **kw):
        super().__init__(K, image_size, faces_per_pixel=faces_per_pixel, **kw)

    def render(self, meshes: Meshes, R, tvec,  # type: ignore[override]
               return_silhouette: bool = False):
        out = super().render(meshes, R, tvec,
                             with_silhouette=return_silhouette)
        return (out.depth, out.silhouette) if return_silhouette else out.depth


class ColorRender(MeshRenderer):
    """Soft-Phong RGB renderer."""

    def __init__(self, K, image_size, blur_radius: float = 0.0,
                 faces_per_pixel: int = 1, **kw):
        super().__init__(K, image_size, blur_radius=blur_radius,
                         faces_per_pixel=faces_per_pixel, **kw)

    def render(self, meshes: Meshes, R, tvec):  # type: ignore[override]
        return super().render(meshes, R, tvec, with_silhouette=False,
                              with_rgb=True, soft_rgb=True).rgb


class SilhouetteRender(MeshRenderer):
    """Soft-silhouette-only renderer (SoftSilhouetteShader equivalent);
    blur_radius defaults to log(1/1e-4 - 1) * sigma."""

    def __init__(self, K, image_size, sigma: float = 1e-4,
                 faces_per_pixel: int = 8,
                 blur_radius: Optional[float] = None, **kw):
        if blur_radius is None:
            blur_radius = math.log(1.0 / 1e-4 - 1.0) * sigma
        super().__init__(K, image_size, blur_radius=blur_radius,
                         faces_per_pixel=faces_per_pixel, sigma=sigma, **kw)

    def render(self, meshes: Meshes, R, tvec):  # type: ignore[override]
        return super().render(meshes, R, tvec, with_silhouette=True).silhouette


# ---------------------------------------------------------------------------
# Point-cloud renderers
# ---------------------------------------------------------------------------

class PointsRenderer(DifferentiableRenderer):
    """Base point renderer: splat rasterization plus a compositor.

    bin_size follows pytorch3d's contract: None (default) = auto
    coarse-to-fine binning with budgets measured from the first concrete
    cloud per shape (rasterize/autotune.py); 0 = dense; k > 0 = explicit
    binned, with max_points_per_bin sized for the concrete cloud by
    rasterize.points.suggest_points_per_bin (overflowing tiles drop
    points)."""

    def __init__(
        self, K, image_size: Tuple[int, int], radius: float = 0.01,
        points_per_pixel: int = 8, pixel_chunk: int = 8192,
        bin_size: Optional[int] = None, max_points_per_bin: int = 128,
        active_tiles: Optional[int] = None, impl: str = "auto",
        check_budgets: Optional[str] = None, device=None,
    ):
        super().__init__(K, image_size, device)
        self.settings = PointsRasterizationSettings(
            image_size=self._image_size, radius=radius,
            points_per_pixel=points_per_pixel, pixel_chunk=pixel_chunk,
            bin_size=bin_size, max_points_per_bin=max_points_per_bin,
            active_tiles=active_tiles, impl=impl,
            check_budgets=check_budgets,
        )

    def resolved_settings(self, pointclouds: Pointclouds, R, tvec,
                          radius=None, grow: bool = False
                          ) -> PointsRasterizationSettings:
        """The concrete settings this cloud rasterizes with: auto
        (bin_size=None) resolves through rasterize.autotune (cached per
        shape); explicit settings pass through. radius: the per-point NDC
        selection radii the rasterization will use. grow=True re-measures a
        cached resolution and keeps the larger budgets."""
        if self.settings.bin_size is not None:
            return self.settings
        from .rasterize.autotune import resolve_points_settings

        return resolve_points_settings(
            self.settings, pointclouds, self.camera_with_pose(R, tvec),
            radius, grow=grow)

    def prepare(self, pointclouds: Pointclouds, R, tvec, radius=None,
                grow: bool = False) -> PointsRasterizationSettings:
        """Resolve auto settings at set-up, so no later render reads counts
        back to the host."""
        return self.resolved_settings(pointclouds, R, tvec, radius,
                                      grow=grow)

    def rasterize(self, pointclouds: Pointclouds, R, tvec, radius=None,
                  extra=None, settings=None):
        cam = self.camera_with_pose(R, tvec)
        return rasterize_points(
            pointclouds, cam,
            self.settings if settings is None else settings, radius,
            extra=extra), cam

    def _splats(self, pointclouds: Pointclouds, R, tvec, radius=None):
        """Fragments, splat weights and per-splat features. On the binned
        path the features and any per-point radius ride the winner gather
        (PointFragments.features); the dense path gathers them per hit."""
        st = self.resolved_settings(pointclouds, R, tvec, radius)
        B, N = pointclouds.points.shape[:2]
        r_arr = None if radius is None else scalar_tensor(
            radius, torch.float32, self.device).expand(B, N)
        nf, extra = 0, None
        if st.bin_size:
            cols = []
            if pointclouds.features is not None:
                cols.append(pointclouds.features)
                nf = pointclouds.features.shape[-1]
            if r_arr is not None:
                cols.append(r_arr[..., None])
            if cols:
                extra = torch.cat(cols, dim=-1)
        frags, _ = self.rasterize(pointclouds, R, tvec, radius, extra=extra,
                                  settings=st)
        # weights follow the radius each splat was selected with
        if r_arr is None:
            w = splat_weights(frags, self.settings.radius)
        elif frags.features is not None:
            w = splat_weights(frags, frags.features[..., nf])
        else:
            r_hit = r_arr.gather(1, frags.idx.clamp_min(0).reshape(B, -1))
            w = splat_weights(frags, r_hit.reshape(frags.idx.shape))
        if frags.features is not None and nf:
            feats = frags.features[..., :nf]
        else:
            feats = gather_point_features(pointclouds, frags)
        return frags, w, feats


class AlphaPointRender(PointsRenderer):
    """Front-to-back alpha-composited point splats -> (B, H, W, C + 1)."""

    def render(self, pointclouds: Pointclouds, R, tvec) -> torch.Tensor:
        _, w, feats = self._splats(pointclouds, R, tvec)
        return alpha_composite(w, feats)


class NormPointRender(PointsRenderer):
    """Normalized-weight composited point splats -> (B, H, W, C + 1)."""

    def render(self, pointclouds: Pointclouds, R, tvec) -> torch.Tensor:
        _, w, feats = self._splats(pointclouds, R, tvec)
        return norm_weighted_composite(w, feats)


class PulsarPointRender(PointsRenderer):
    """A fast approximation of Pulsar: 2D splats (NDC radius) blended by a
    softmax over center depth with temperature gamma. PulsarRenderer is
    the sphere-based model."""

    def __init__(self, K, image_size, gamma: float = 1e-3, **kw):
        super().__init__(K, image_size, **kw)
        self.gamma = gamma

    def render(self, pointclouds: Pointclouds, R, tvec,
               radius=None) -> torch.Tensor:
        frags, w, feats = self._splats(pointclouds, R, tvec, radius)
        return pulsar_composite(frags, w, feats, gamma=self.gamma)


class PulsarRenderer(PointsRenderer):
    """Sphere-based Pulsar renderer (Lassner & Zollhoefer, CVPR 2021):
    spheres with world radii and per-sphere opacity; per pixel the K
    nearest spheres are intersected analytically and blended by a softmax
    over normalized intersection depth with temperature gamma and an
    exp(eps / gamma) background weight
    (shading.compositing.pulsar_sphere_composite). Returns (B, H, W, C + 1).

    radius: the default world radius (render(radius=) overrides it per
    point); opacity defaults to 1. Selection runs with each sphere's NDC
    extent at its near surface, r_ndc = r_w fmax / (ndc_scale (z - r_w)),
    which grows without bound near the camera: auto budgets are sized
    against these radii, and explicit budgets should be too
    (suggest_points_per_bin(radius=r_ndc)); overflowing tiles drop
    spheres."""

    def __init__(self, K, image_size, gamma: float = 1e-2,
                 radius: float = 0.05, znear: float = 0.1,
                 zfar: float = 10.0, background: float = 0.0,
                 eps: float = 1e-3, **kw):
        super().__init__(K, image_size, radius=radius, **kw)
        self.gamma = gamma
        self.znear = znear
        self.zfar = zfar
        self.background = background
        self.eps = eps

    def _selection_radii(self, pointclouds: Pointclouds, cam, radius=None):
        """(pts_cam, r_w, r_ndc): camera-frame centers, world radii and the
        NDC selection radii (each sphere's screen extent at its near
        surface, so the top-K candidates hold every sphere a ray can
        hit)."""
        pts_cam = cam.world_to_camera(pointclouds.points)
        B, N = pts_cam.shape[:2]
        r_w = scalar_tensor(
            self.settings.radius if radius is None else radius,
            torch.float32, pts_cam.device).expand(B, N)
        fmax = torch.maximum(cam.fx, cam.fy)[:, None]
        r_ndc = r_w * fmax / (cam.ndc_scale * torch.clamp_min(
            pts_cam[..., 2] - r_w, self.settings.znear))
        return pts_cam, r_w, r_ndc

    def resolved_settings(self, pointclouds: Pointclouds, R, tvec,
                          radius=None, grow: bool = False
                          ) -> PointsRasterizationSettings:
        """Auto settings sized against the NDC selection radii this
        renderer rasterizes with; ``radius`` is the world radius override,
        as in render()."""
        if self.settings.bin_size is not None:
            return self.settings
        cam = self.camera_with_pose(R, tvec)
        _, _, r_ndc = self._selection_radii(pointclouds, cam, radius)
        return self._resolve_with_radii(pointclouds, cam, r_ndc, grow=grow)

    def _resolve_with_radii(self, pointclouds, cam, r_ndc, grow=False):
        from .rasterize.autotune import resolve_points_settings

        return resolve_points_settings(self.settings, pointclouds, cam,
                                       r_ndc, grow=grow)

    def render(self, pointclouds: Pointclouds, R, tvec, radius=None,
               opacity=None) -> torch.Tensor:
        cam = self.camera_with_pose(R, tvec)
        pts_cam, r_w, r_ndc = self._selection_radii(pointclouds, cam, radius)
        B, N = pts_cam.shape[:2]
        o = scalar_tensor(1.0 if opacity is None else opacity,
                          torch.float32, pts_cam.device).expand(B, N)
        feats = (torch.ones((B, N, 3), device=pts_cam.device)
                 if pointclouds.features is None else pointclouds.features)
        st = self.settings
        if st.bin_size is None:
            st = self._resolve_with_radii(pointclouds, cam, r_ndc)
        # binned: every per-sphere channel the blend needs rides the winner
        # gather (packed_hit_channels) instead of five per-hit gathers
        extra = None
        if st.bin_size:
            extra = torch.cat([pts_cam, r_w[..., None], o[..., None], feats],
                              dim=-1)
        frags = rasterize_points(pointclouds, cam, st, r_ndc, extra=extra)
        packed = frags.features if extra is not None else None
        bcast = lambda a: a.expand(B)                         # noqa: E731
        return pulsar_sphere_composite(
            frags, pts_cam, r_w, o, feats, bcast(cam.fx), bcast(cam.fy),
            bcast(cam.cx), bcast(cam.cy), self._image_size, gamma=self.gamma,
            znear=self.znear, zfar=self.zfar, background=self.background,
            eps=self.eps, packed_hit_channels=packed)


class DepthPointRender(PointsRenderer):
    """Nearest-splat depth map (B, H, W), background 0."""

    def render(self, pointclouds: Pointclouds, R, tvec) -> torch.Tensor:
        frags, _ = self.rasterize(pointclouds, R, tvec)
        return torch.relu(frags.zbuf[..., 0])

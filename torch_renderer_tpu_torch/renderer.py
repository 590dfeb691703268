"""High-level mesh renderers (PyTorch counterpart of the mesh renderers in
``torch_renderer_tpu.renderer``).

Each renderer rasterizes once and derives every requested output (depth,
soft silhouette, soft-Phong RGB) from the shared fragments. ``render``
methods take OpenCV (R, tvec) extrinsics directly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from .cameras.perspective import PerspectiveCamera, _as_batched
from .rasterize.fragments import Fragments
from .rasterize.raster import RasterizationSettings, rasterize_meshes
from .shading.blending import BlendParams, sigmoid_alpha
from .shading.lights import Materials, PointLights
from .shading.phong import hard_phong_shader, soft_phong_shader
from .structures.meshes import Meshes


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
    on ``device`` (the CPU by default)."""

    def __init__(self, K, image_size: Tuple[int, int], device=None):
        if not isinstance(image_size, tuple):
            raise ValueError("image_size must be a tuple, e.g. (720, 1280)")
        K_t = _as_batched(K, 2, device)
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
    BlendParams' default."""

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
        check_budgets: Optional[str] = None, device=None,
    ):
        super().__init__(K, image_size, device)
        self.shade_k = shade_k
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

"""Face setup stage of the rasterizer (PyTorch counterpart of
``torch_renderer_tpu.rasterize.geometry``): project mesh vertices into raster
space and gather per-face corner channel planes.

Raster space: x = (u - W/2) / s, y = (v - H/2) / s with s = min(H, W)/2
(pytorch3d's non-square-NDC scaling), so sigma values carry over unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..cameras.perspective import PerspectiveCamera
from ..structures.meshes import Meshes


class FacePlanes(NamedTuple):
    """Per-face screen-space channel planes, each (B, F). x/y are raster
    coords of corners 0-2; z is camera-space depth; valid marks real,
    front-of-camera, non-degenerate faces."""

    x0: torch.Tensor
    y0: torch.Tensor
    x1: torch.Tensor
    y1: torch.Tensor
    x2: torch.Tensor
    y2: torch.Tensor
    z0: torch.Tensor
    z1: torch.Tensor
    z2: torch.Tensor
    valid: torch.Tensor

    @property
    def num_faces(self) -> int:
        return self.x0.shape[1]


def setup_face_planes(
    meshes: Meshes, camera: PerspectiveCamera, znear: float = 1e-5,
    eps_area: float = 1e-12,
) -> FacePlanes:
    """Project meshes through the camera into per-face corner planes.

    Faces with any corner at z <= znear are invalid (no near-plane clipping,
    as pytorch3d's default discards them), and so are faces whose doubled
    raster area is at most eps_area. Corners are taken by plain indexing;
    its backward is autograd's scatter-add.
    """
    H, W = camera.image_size
    s = camera.ndc_scale

    verts_cam = camera.world_to_camera(meshes.verts)  # (B, V, 3)
    uv, z = camera.project(verts_cam)
    x = (uv[..., 0] - W / 2.0) / s
    y = (uv[..., 1] - H / 2.0) / s

    corners = [meshes.faces[:, :, k] for k in range(3)]
    xs = [x.gather(1, c) for c in corners]
    ys = [y.gather(1, c) for c in corners]
    zs = [z.gather(1, c) for c in corners]

    front = (zs[0] > znear) & (zs[1] > znear) & (zs[2] > znear)
    area2 = (xs[1] - xs[0]) * (ys[2] - ys[0]) - (ys[1] - ys[0]) * (xs[2] - xs[0])
    valid = (meshes.face_mask() > 0) & front & (area2.abs() > eps_area)
    return FacePlanes(
        x0=xs[0], y0=ys[0], x1=xs[1], y1=ys[1], x2=xs[2], y2=ys[2],
        z0=zs[0], z1=zs[1], z2=zs[2], valid=valid,
    )

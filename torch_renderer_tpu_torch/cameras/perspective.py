"""Perspective pinhole cameras in the OpenCV convention (PyTorch counterpart of
``torch_renderer_tpu.cameras.perspective.PerspectiveCamera``).

  * camera frame: +x right, +y down, +z forward (into the scene);
  * extrinsics:  X_cam = R @ X_world + t;
  * projection:  u = fx * x/z + cx,  v = fy * y/z + cy  (pixels);
  * pixel centers at integer coordinates + 0.5; u indexes width, v height.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


def _as_batched(x, last_dims: int, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = np.array(x, dtype=np.float32)   # a writable copy (x may be a view)
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    while x.ndim < last_dims + 1:
        x = x[None]
    return x


@dataclasses.dataclass(frozen=True)
class PerspectiveCamera:
    """Batched pinhole camera: intrinsics in pixels + OpenCV extrinsics.

    fx, fy, cx, cy: (B,) focal lengths / principal point in pixels.
    R: (B, 3, 3), t: (B, 3) with X_cam = R @ X_world + t.
    """

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    image_size: Tuple[int, int]

    @staticmethod
    def from_K(K, image_size: Tuple[int, int], R=None, t=None,
               device=None) -> "PerspectiveCamera":
        """Build from a 3x3 (or (B, 3, 3)) pinhole matrix K."""
        K = _as_batched(K, 2, device)
        B = K.shape[0]
        if R is None:
            R = torch.eye(3, device=K.device).expand(B, 3, 3)
        else:
            R = _as_batched(R, 2, K.device)
        if t is None:
            t = torch.zeros((B, 3), device=K.device)
        else:
            t = _as_batched(t, 1, K.device)
        return PerspectiveCamera(
            fx=K[:, 0, 0], fy=K[:, 1, 1], cx=K[:, 0, 2], cy=K[:, 1, 2],
            R=R, t=t, image_size=(int(image_size[0]), int(image_size[1])),
        )

    def K(self) -> torch.Tensor:
        """(B, 3, 3) pinhole matrices."""
        B = self.fx.shape[0]
        K = torch.zeros((B, 3, 3), dtype=torch.float32, device=self.fx.device)
        K[:, 0, 0] = self.fx
        K[:, 1, 1] = self.fy
        K[:, 0, 2] = self.cx
        K[:, 1, 2] = self.cy
        K[:, 2, 2] = 1.0
        return K

    def replace_pose(self, R, t) -> "PerspectiveCamera":
        """The same intrinsics with extrinsics (R, t); (3, 3) / (3,) inputs
        gain a batch dim, and they keep their autograd history."""
        return dataclasses.replace(self, R=_as_batched(R, 2, self.fx.device),
                                   t=_as_batched(t, 1, self.fx.device))

    def camera_center_world(self) -> torch.Tensor:
        """(B, 3) camera origin in world coordinates: -R^T t."""
        return -torch.einsum("bji,bj->bi", self.R, self.t)

    @property
    def ndc_scale(self) -> float:
        """Pixels per raster unit: the shorter image side spans [-1, 1]."""
        return min(self.image_size) / 2.0

    def world_to_camera(self, points: torch.Tensor) -> torch.Tensor:
        """(B?, P, 3) world -> (B, P, 3) camera frame."""
        eq = "bij,pj->bpi" if points.ndim == 2 else "bij,bpj->bpi"
        return torch.einsum(eq, self.R, points) + self.t[:, None, :]

    def project(self, points_cam: torch.Tensor, eps: float = 1e-8):
        """Camera-frame points (B, P, 3) -> pixel coords (B, P, 2) and z (B, P).

        z is clamped away from 0 with its sign preserved so gradients stay
        finite for points behind the camera (they are culled downstream).
        """
        z = points_cam[..., 2]
        signed_eps = torch.where(z < 0, -eps, eps)
        z_safe = torch.where(z.abs() < eps, signed_eps, z)
        u = self.fx[:, None] * points_cam[..., 0] / z_safe + self.cx[:, None]
        v = self.fy[:, None] * points_cam[..., 1] / z_safe + self.cy[:, None]
        return torch.stack([u, v], dim=-1), z

    def to(self, device) -> "PerspectiveCamera":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device)
                     for f in ("fx", "fy", "cx", "cy", "R", "t")})

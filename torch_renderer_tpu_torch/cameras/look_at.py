"""Look-at camera poses in the OpenCV convention (PyTorch counterpart of
``torch_renderer_tpu.cameras.look_at``).

Every function returns OpenCV extrinsics (X_cam = R @ X_world + t, camera
+x right / +y down / +z forward). Inputs may be Python numbers, numpy arrays
or tensors; results are float32 tensors on the device of a tensor input
(the CPU otherwise).
"""

from __future__ import annotations

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _normalize(v: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(eps)


def look_at_rotation_opencv(eye, at=None, up=None) -> torch.Tensor:
    """Rotation R (world->camera) for a camera at `eye` looking at `at`.

    eye (..., 3); at (..., 3), default the origin; up (..., 3), default +Y.
    The rows of R are the camera axes in world coordinates:
    z = normalize(at - eye), x = normalize(z x up), y = z x x."""
    eye = _f32(eye)
    at = torch.zeros_like(eye) if at is None else \
        _f32(at).to(eye.device).expand(eye.shape)
    up = _f32([0.0, 1.0, 0.0] if up is None else up).to(eye.device) \
        .expand(eye.shape)
    z = _normalize(at - eye)
    x = torch.linalg.cross(z, up)
    # forward parallel to up: any right vector orthogonal to z will do
    bad = torch.linalg.norm(x, dim=-1, keepdim=True) < 1e-6
    alt = torch.linalg.cross(
        z, _f32([1.0, 0.0, 0.0]).to(eye.device).expand(z.shape))
    x = _normalize(torch.where(bad, alt, x))
    y = torch.linalg.cross(z, x)
    return torch.stack([x, y, z], dim=-2)


def look_at_opencv(eye, at=None, up=None):
    """(R, t) OpenCV extrinsics for a camera at `eye` looking at `at`."""
    R = look_at_rotation_opencv(eye, at, up)
    eye = _f32(eye).to(R.device)
    t = -torch.einsum("...ij,...j->...i", R, eye)
    return R, t


def camera_position_from_spherical_angles(dist, elev, azim,
                                          degrees: bool = True):
    """Camera position on a sphere, pytorch3d's parameterization:
    eye = dist * (cos(elev) sin(azim), sin(elev), cos(elev) cos(azim))."""
    dist, elev, azim = (torch.atleast_1d(_f32(a)) for a in (dist, elev, azim))
    if degrees:
        elev = torch.deg2rad(elev)
        azim = torch.deg2rad(azim)
    dist, elev, azim = torch.broadcast_tensors(dist, elev, azim)
    x = dist * torch.cos(elev) * torch.sin(azim)
    y = dist * torch.sin(elev)
    z = dist * torch.cos(elev) * torch.cos(azim)
    return torch.stack([x, y, z], dim=-1)


def look_at_view_transform(dist=1.0, elev=0.0, azim=0.0, *,
                           degrees: bool = True, at=None, up=None,
                           inplane_rotation=None):
    """OpenCV (R, t) for the pytorch3d-style (dist, elev, azim) viewpoint.

    ``inplane_rotation`` (radians, (...,)) optionally rolls the camera about
    its optical axis."""
    eye = camera_position_from_spherical_angles(dist, elev, azim,
                                                degrees=degrees)
    if at is not None:
        at = _f32(at).expand(eye.shape)
        eye = eye + at
    R, t = look_at_opencv(eye, at, up)
    if inplane_rotation is not None:
        theta = torch.atleast_1d(_f32(inplane_rotation))
        c, s = torch.cos(theta), torch.sin(theta)
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        Rz = torch.stack([c, -s, zero, s, c, zero, zero, zero, one],
                         dim=-1).reshape(theta.shape + (3, 3))
        R = Rz @ R
        t = torch.einsum("...ij,...j->...i", Rz, t)
    return R, t

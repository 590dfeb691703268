"""Face setup stage of the rasterizer (PyTorch counterpart of
``torch_renderer_tpu.rasterize.geometry``): project mesh vertices into raster
space and gather per-face corner data, either as channel planes
(FacePlanes, read by the binned paths) or as FaceRasterData (the dense
path's corner tensors and edge coefficients).

Raster space: x = (u - W/2) / s, y = (v - H/2) / s with s = min(H, W)/2
(pytorch3d's non-square-NDC scaling), so sigma values carry over unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..cameras.perspective import PerspectiveCamera
from ..structures.meshes import Meshes
from ..utils.timing import span


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
    its backward is autograd's scatter-add. Runs in the span "setup" (the
    camera transform with it).
    """
    with span("setup", meshes.verts) as sp:
        meshes, camera = sp.inputs(meshes, camera)
        return sp.outputs(_setup_face_planes(meshes, camera, znear,
                                             eps_area))


def _setup_face_planes(meshes: Meshes, camera: PerspectiveCamera,
                       znear: float, eps_area: float) -> FacePlanes:
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


@dataclasses.dataclass(frozen=True)
class FaceRasterData:
    """Per-face screen-space quantities, all batched (B, F, ...)."""

    q: torch.Tensor       # (B, F, 3, 2) corner positions in raster space
    z: torch.Tensor       # (B, F, 3) corner camera-space z
    invz: torch.Tensor    # (B, F, 3) 1/z (z clamped to znear)
    area2: torch.Tensor   # (B, F) signed doubled area in raster space
    abc: torch.Tensor     # (B, F, 3, 3) edge-function coefficients (a, b, c)
                          # per edge k, edge k opposite corner k
    zden: torch.Tensor    # (B, F, 3) coefficients of sum_k e_k(p) * invz_k
    valid: torch.Tensor   # (B, F) bool: real, front-of-camera, non-degenerate

    @property
    def num_faces(self) -> int:
        return self.q.shape[1]


def setup_faces(
    meshes: Meshes, camera: PerspectiveCamera, znear: float = 1e-5,
    eps_area: float = 1e-12,
) -> FaceRasterData:
    """Project meshes through the camera and build per-face raster data.

    Faces with any corner at z <= znear are invalid (no near-plane
    clipping), and so are padded and degenerate faces. Runs in the span
    "setup" (the camera transform with it)."""
    with span("setup", meshes.verts) as sp:
        meshes, camera = sp.inputs(meshes, camera)
        return sp.outputs(_setup_faces(meshes, camera, znear, eps_area))


def _setup_faces(meshes: Meshes, camera: PerspectiveCamera, znear: float,
                 eps_area: float) -> FaceRasterData:
    H, W = camera.image_size
    s = camera.ndc_scale

    verts_cam = camera.world_to_camera(meshes.verts)  # (B, V, 3)
    uv, z = camera.project(verts_cam)
    x = (uv[..., 0] - W / 2.0) / s
    y = (uv[..., 1] - H / 2.0) / s
    pts = torch.stack([x, y], dim=-1)                 # (B, V, 2)

    B, F, _ = meshes.faces.shape
    idx = meshes.faces.reshape(B, F * 3, 1)
    q = pts.gather(1, idx.expand(B, F * 3, 2)).reshape(B, F, 3, 2)
    fz = z.gather(1, idx[..., 0]).reshape(B, F, 3)

    front = (fz > znear).all(-1)
    invz = 1.0 / fz.clamp_min(znear)
    q0, q1, q2 = q[..., 0, :], q[..., 1, :], q[..., 2, :]

    def cross2(u, v):
        return u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]

    area2 = cross2(q1 - q0, q2 - q0)

    def edge_coeffs(qa, qb):
        # e(p) = cross(qb - qa, p - qa) = a px + b py + c
        g = qb - qa
        return torch.stack([-g[..., 1], g[..., 0],
                            g[..., 1] * qa[..., 0] - g[..., 0] * qa[..., 1]],
                           dim=-1)

    abc = torch.stack([edge_coeffs(q1, q2), edge_coeffs(q2, q0),
                       edge_coeffs(q0, q1)], dim=-2)  # (B, F, 3, 3)
    zden = torch.einsum("bfk,bfkc->bfc", invz, abc)
    valid = (meshes.face_mask() > 0) & front & (area2.abs() > eps_area)
    return FaceRasterData(q=q, z=fz, invz=invz, area2=area2, abc=abc,
                          zden=zden, valid=valid)


def point_to_edges_dist2(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Min squared distance from points p (..., 2) to the three edge
    segments of triangles q (..., 3, 2), broadcast -> (...,)."""
    d2s = []
    for a_i, b_i in ((0, 1), (1, 2), (2, 0)):
        qa = q[..., a_i, :]
        g = q[..., b_i, :] - qa
        len2 = (g * g).sum(-1).clamp_min(1e-12)
        w = p - qa
        t = ((w * g).sum(-1) / len2).clamp(0.0, 1.0)
        d = p - (qa + t[..., None] * g)
        d2s.append((d * d).sum(-1))
    return torch.minimum(torch.minimum(d2s[0], d2s[1]), d2s[2])


def channel_edge_bary(px, py, qx, qy):
    """Edge functions and (screen-space) barycentrics from six corner
    channels; px/py broadcast against them. Edge k is opposite corner k.
    Returns (bary 3-list, inside).

    Every operation is one rounded float32 op in a fixed order (the hard
    kernels in csrc/hard_raster.cu repeat it op for op), so the plain and
    kernel selections agree bit for bit."""
    def cross_e(ax, ay, bx, by):
        return (bx - ax) * (py - ay) - (by - ay) * (px - ax)

    e0 = cross_e(qx[1], qy[1], qx[2], qy[2])
    e1 = cross_e(qx[2], qy[2], qx[0], qy[0])
    e2 = cross_e(qx[0], qy[0], qx[1], qy[1])
    area2 = (qx[1] - qx[0]) * (qy[2] - qy[0]) - (qy[1] - qy[0]) * (
        qx[2] - qx[0])
    inv_area = 1.0 / torch.where(area2.abs() > 1e-12, area2,
                                 torch.ones_like(area2))
    bary = [e0 * inv_area, e1 * inv_area, e2 * inv_area]
    inside = (bary[0] >= 0.0) & (bary[1] >= 0.0) & (bary[2] >= 0.0)
    return bary, inside


def channel_min_edge_dist2(px, py, qx, qy):
    """Min over the three edges of the clamped point-to-segment squared
    distance, >= 0, from six corner channels. t = wg / len2 per pair: the
    hard-selection rounding family (the soft kernels hoist 1/len2 per face
    instead and must not be merged with this)."""
    d2 = None
    for a_i, b_i in ((0, 1), (1, 2), (2, 0)):
        gx = qx[b_i] - qx[a_i]
        gy = qy[b_i] - qy[a_i]
        len2 = (gx * gx + gy * gy).clamp_min(1e-12)
        wx = px - qx[a_i]
        wy = py - qy[a_i]
        wg = wx * gx + wy * gy
        t = (wg / len2).clamp(0.0, 1.0)
        dd = wx * wx + wy * wy - 2.0 * t * wg + t * t * len2
        d2 = dd if d2 is None else torch.minimum(d2, dd)
    return d2.clamp_min(0.0)


def fragment_math(px, py, qx, qy, zf, invzf, clip_bary: bool):
    """Differentiable fragment values of one face per pixel (the JAX
    package's ``raster._fragment_math``): px, py and the gathered corner
    channels qx, qy, zf, invzf (3-lists) broadcast to one shape S. Returns
    (zbuf, pc 3-list, dists), each of shape S.

    zbuf interpolates z with the raw barycentrics perspective-corrected (and
    clipped to the simplex when clip_bary); dists is the signed squared
    boundary distance, negative inside. The K=1 kernel in
    csrc/hard_raster.cu repeats these operations in this order."""
    bary, inside = channel_edge_bary(px, py, qx, qy)
    npc = [bary[k] * invzf[k] for k in range(3)]
    denom = (npc[0] + npc[1] + npc[2]).clamp_min(1e-12)
    pc = [npc[k] / denom for k in range(3)]
    if clip_bary:
        rp = [torch.relu(p) for p in pc]
        rden = (rp[0] + rp[1] + rp[2]).clamp_min(1e-12)
        pc = [p / rden for p in rp]
    zbuf = pc[0] * zf[0] + pc[1] * zf[1] + pc[2] * zf[2]
    d2 = channel_min_edge_dist2(px, py, qx, qy)
    return zbuf, pc, torch.where(inside, -d2, d2)

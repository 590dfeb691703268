"""Differentiable surface point sampling (PyTorch counterpart of
``torch_renderer_tpu.ops.sample_points``, pytorch3d's
sample_points_from_meshes).

Faces are chosen with probability proportional to their area (padded and
degenerate faces never), then each point is placed uniformly in its face by
the square-root trick. The face choice is discrete and not differentiated;
the positions are differentiable in the vertices.

The random draws are split from the deterministic part:
``sample_points_at(meshes, face_idx, r)`` maps given face choices and
uniform draws to points, so one set of draws gives the same points in this
package and in the JAX package, whose random streams differ.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..structures.meshes import Meshes


def sample_points_at(meshes: Meshes, face_idx: torch.Tensor,
                     r: torch.Tensor, return_normals: bool = False):
    """Points (B, S, 3) on faces face_idx (B, S) at the uniform draws r
    (B, S, 2): barycentrics (1 - sqrt(r0), r1 sqrt(r0), rest)."""
    B, F, _ = meshes.faces.shape
    S = face_idx.shape[1]
    fv = meshes.face_verts().reshape(B, F, 9)
    corners = fv.gather(1, face_idx[..., None].expand(B, S, 9))
    corners = corners.reshape(B, S, 3, 3)
    s = torch.sqrt(r[..., 0])
    w0 = 1.0 - s
    w1 = r[..., 1] * s
    w2 = 1.0 - w0 - w1
    bary = torch.stack([w0, w1, w2], dim=-1)
    points = torch.einsum("bsk,bskc->bsc", bary, corners)
    if not return_normals:
        return points
    fn = meshes.face_normals()
    return points, fn.gather(1, face_idx[..., None].expand(B, S, 3))


def sample_points_from_meshes(meshes: Meshes, num_samples: int,
                              generator: Optional[torch.Generator] = None,
                              return_normals: bool = False):
    """Sample (B, num_samples, 3) points uniformly over each mesh surface.
    The draws come from ``generator`` (on the meshes' device; torch's
    default generator when None)."""
    with torch.no_grad():
        areas = meshes.face_areas()
        probs = torch.where((meshes.face_mask() > 0) & (areas > 0), areas,
                            torch.zeros_like(areas))
        face_idx = torch.multinomial(probs, num_samples, replacement=True,
                                     generator=generator)
        r = torch.rand((meshes.batch_size, num_samples, 2),
                       device=meshes.device, generator=generator)
    return sample_points_at(meshes, face_idx, r, return_normals)

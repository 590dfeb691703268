"""G-buffer decodes from fragments: normals, instance ids, visibility
(PyTorch counterpart of ``torch_renderer_tpu.shading.gbuffer``).

The reference gets these from Blender's render passes
(coco_data_generator.py:352-358: RGB + depth + normals + instance
segmentation). Here they are gathers over the shared Fragments: one
rasterization feeds every pass.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..cameras.perspective import PerspectiveCamera
from ..rasterize.fragments import Fragments, interpolate_face_attributes
from ..structures.meshes import Meshes
from ..structures.textures import _gather_rows


def render_normals(meshes: Meshes, fragments: Fragments,
                   camera: Optional[PerspectiveCamera] = None,
                   space: str = "world") -> torch.Tensor:
    """Smooth-shaded normal map (B, H, W, 3) of the nearest hit; zeros on
    background. space='camera' rotates into the camera frame (the normals
    pass convention of the reference's BlenderProc pipeline)."""
    fv_normals = _gather_rows(meshes.vertex_normals(), meshes.faces)
    n = interpolate_face_attributes(
        fragments.pix_to_face[..., :1], fragments.bary[..., :1, :],
        fv_normals)[..., 0, :]
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-12)
    if space == "camera":
        if camera is None:
            raise ValueError("camera required for camera-space normals")
        n = torch.einsum("bij,bhwj->bhwi", camera.R, n)
    return torch.where(fragments.hard_mask()[..., None], n,
                       torch.zeros_like(n))


def instance_segmentation(fragments: Fragments,
                          face_to_object: torch.Tensor) -> torch.Tensor:
    """Instance-id map (B, H, W) int32 from the nearest fragment; -1 =
    background. face_to_object: (F,) object index per face (scenes.py)."""
    p2f = fragments.pix_to_face[..., 0]
    ids = face_to_object[p2f.clamp_min(0)]
    return torch.where(p2f >= 0, ids, torch.full_like(ids, -1)).to(
        torch.int32)


def instance_masks(fragments: Fragments, face_to_object: torch.Tensor,
                   n_objects: int) -> torch.Tensor:
    """Per-object boolean masks (B, N, H, W)."""
    seg = instance_segmentation(fragments, face_to_object)
    objs = torch.arange(n_objects, dtype=torch.int32, device=seg.device)
    return seg[:, None, :, :] == objs[None, :, None, None]


def visibility_fraction(fragments: Fragments, face_to_object: torch.Tensor,
                        n_objects: int) -> torch.Tensor:
    """Fraction of image pixels covered per object (B, N), to filter
    barely visible annotations as the reference's COCO writer does."""
    masks = instance_masks(fragments, face_to_object, n_objects)
    return masks.to(torch.float32).mean(dim=(-2, -1))

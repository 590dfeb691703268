"""Multi-object scene assembly: merge meshes into one renderable with a
per-face object-id table (PyTorch counterpart of
``torch_renderer_tpu.structures.scenes``).

The reference composes multi-object scenes in Blender
(coco_data_generator.py:174-309). Here every object goes into one padded
Meshes, and the face-to-object table decodes fragments into instance masks
(shading/gbuffer.py). The sampling helpers are host-side numpy.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from .meshes import Meshes
from .textures import TexturesUV, TexturesVertex


@dataclasses.dataclass(frozen=True)
class SceneMeshes:
    """A flattened multi-object scene.

    meshes: single-batch (B=1) padded Meshes containing every object.
    face_to_object: (F,) int32 object index per face (-1 for padding), on
    the meshes' device.
    object_categories: (N,) int32 category id per object.
    n_annotated: objects [0, n_annotated) are annotation targets; objects
    at or after it (distractors, room geometry) render and occlude but never
    appear in annotations. None = every object is a target.
    """

    meshes: Meshes
    face_to_object: torch.Tensor
    object_categories: np.ndarray
    n_annotated: Optional[int] = None


def merge_meshes(
    verts_list: Sequence[np.ndarray],
    faces_list: Sequence[np.ndarray],
    colors_list: Optional[Sequence[np.ndarray]] = None,
    categories: Optional[Sequence[int]] = None,
    pad_verts_to: Optional[int] = None,
    pad_faces_to: Optional[int] = None,
    uvs_list: Optional[Sequence[np.ndarray]] = None,
    texture_map: Optional[np.ndarray] = None,
    device=None,
) -> SceneMeshes:
    """Concatenate per-object (Vi, 3) / (Fi, 3) arrays into one mesh with
    offset faces, on ``device`` (default: the card).

    colors_list: optional per-object per-vertex RGB -> TexturesVertex.
    uvs_list + texture_map: optional per-object per-vertex (Vi, 2) UVs into
    a shared (H, W, 3) map -> TexturesUV (UVs are per VERTEX, so faces_uvs
    reuses the padded faces table; datagen.texgen.pack_atlas builds the
    shared map). Mutually exclusive with colors_list.
    pad_verts_to / pad_faces_to: a fixed padded size, so that every sampled
    scene has one shape (padding faces get object id -1).
    """
    if uvs_list is not None and colors_list is not None:
        raise ValueError("pass colors_list OR uvs_list+texture_map, not both")
    if (uvs_list is None) != (texture_map is None):
        raise ValueError("uvs_list and texture_map go together")
    device = resolve_device(device)
    verts_np = [np.asarray(v, np.float32) for v in verts_list]
    faces_np = [np.asarray(f, np.int64) for f in faces_list]
    offsets = np.cumsum([0] + [v.shape[0] for v in verts_np[:-1]])
    all_verts = np.concatenate(verts_np, axis=0)
    all_faces = np.concatenate(
        [f + o for f, o in zip(faces_np, offsets)], axis=0).astype(np.int32)
    face_obj = np.concatenate(
        [np.full(f.shape[0], i, np.int32) for i, f in enumerate(faces_np)])
    if pad_faces_to is not None and pad_faces_to > face_obj.shape[0]:
        face_obj = np.concatenate(
            [face_obj, np.full(pad_faces_to - face_obj.shape[0], -1, np.int32)])

    textures = None
    if colors_list is not None:
        all_colors = np.concatenate(
            [np.asarray(c, np.float32) for c in colors_list], axis=0)
        if pad_verts_to is not None and pad_verts_to > all_colors.shape[0]:
            all_colors = np.concatenate([
                all_colors,
                np.zeros((pad_verts_to - all_colors.shape[0], 3), np.float32),
            ])
        textures = TexturesVertex(torch.as_tensor(all_colors)[None])

    meshes = Meshes.from_lists(
        [all_verts], [all_faces], device=device, textures=textures,
        pad_verts_to=pad_verts_to, pad_faces_to=pad_faces_to)
    if uvs_list is not None:
        all_uvs = np.concatenate(
            [np.asarray(u, np.float32) for u in uvs_list], axis=0)
        if pad_verts_to is not None and pad_verts_to > all_uvs.shape[0]:
            all_uvs = np.concatenate([
                all_uvs,
                np.full((pad_verts_to - all_uvs.shape[0], 2), 0.5, np.float32),
            ])
        # per-vertex UVs: the padded faces table doubles as faces_uvs
        # (padding faces read vertex 0's UV; they are masked downstream)
        meshes = dataclasses.replace(meshes, textures=TexturesUV(
            maps=torch.as_tensor(np.asarray(texture_map, np.float32),
                                 device=device)[None],
            faces_uvs=meshes.faces,
            verts_uvs=torch.as_tensor(all_uvs, device=device)[None],
        ))
    cats = np.asarray(
        categories if categories is not None else np.zeros(len(verts_np)),
        np.int32)
    return SceneMeshes(
        meshes=meshes,
        face_to_object=torch.as_tensor(face_obj, device=device),
        object_categories=cats,
    )


def place_on_plane(
    verts: np.ndarray, R: np.ndarray, xy: np.ndarray, z_plane: float = 0.0
) -> np.ndarray:
    """Rotate an object and translate it so that its bbox bottom rests on
    the z = z_plane ground at xy (the static stand-in for the reference's
    physics settling)."""
    v = np.asarray(verts, np.float32) @ np.asarray(R, np.float32).T
    lift = z_plane - v[:, 2].min()
    return v + np.array([xy[0], xy[1], lift], np.float32)


def sample_nonoverlapping_xy(
    rng: np.random.Generator, n: int, radius: float, extent: float,
    max_tries: int = 200,
) -> np.ndarray:
    """Rejection-sample n xy positions with pairwise distance > 2*radius
    inside [-extent, extent]^2 (placement without interpenetration)."""
    out: List[np.ndarray] = []
    for _ in range(max_tries):
        if len(out) == n:
            break
        cand = rng.uniform(-extent, extent, 2).astype(np.float32)
        if all(np.linalg.norm(cand - p) > 2 * radius for p in out):
            out.append(cand)
    while len(out) < n:  # fall back to random if too crowded
        out.append(rng.uniform(-extent, extent, 2).astype(np.float32))
    return np.stack(out)


def ground_plane(extent: float = 2.0, z: float = 0.0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Large quad in the z = z plane (the reference's 2 m room floor)."""
    verts = np.array(
        [[-extent, -extent, z], [extent, -extent, z],
         [extent, extent, z], [-extent, extent, z]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return verts, faces


def room_planes(
    extent: float = 2.0, height: float = 2.0, ceiling: bool = False,
    subdiv: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Floor + 4 walls (optional ceiling) enclosing [-extent, extent]^2 x
    [0, height], the reference's 5-plane 2 m room.

    Each plane is a subdiv x subdiv quad grid (vertices shared within the
    plane, so vertex normals are exactly the plane normal): the rasterizer
    culls faces with any corner behind the near plane (no near-plane
    clipping), so room-scale triangles would vanish whenever a camera
    inside the room looks across them; grid cells keep the cull to a sliver
    near the camera. Every normal points inward, so Phong lighting from
    inside the room sees front faces.

    Returns (verts, faces) as one mergeable object:
    verts ((5|6)*(subdiv+1)^2, 3), faces ((5|6)*subdiv^2*2, 3).
    """
    e, h = float(extent), float(height)
    # each plane: (origin, edge_u, edge_v) with inward winding u x v
    planes = [
        ((-e, -e, 0.0), (2 * e, 0, 0), (0, 2 * e, 0)),   # floor, +z
        ((-e, -e, 0.0), (0, 0, h), (2 * e, 0, 0)),       # wall y=-e, +y
        ((-e, e, 0.0), (2 * e, 0, 0), (0, 0, h)),        # wall y=+e, -y
        ((-e, -e, 0.0), (0, 2 * e, 0), (0, 0, h)),       # wall x=-e, +x
        ((e, -e, 0.0), (0, 0, h), (0, 2 * e, 0)),        # wall x=+e, -x
    ]
    if ceiling:
        planes.append(((-e, -e, h), (0, 2 * e, 0), (2 * e, 0, 0)))  # -z
    n = max(1, int(subdiv))
    verts, faces = [], []
    for origin, eu, ev in planes:
        base = len(verts)
        o = np.asarray(origin, np.float32)
        u = np.asarray(eu, np.float32) / n
        v = np.asarray(ev, np.float32) / n
        for j in range(n + 1):
            for i in range(n + 1):
                verts.append(o + i * u + j * v)
        for j in range(n):
            for i in range(n):
                a = base + j * (n + 1) + i
                b, c, d = a + 1, a + 1 + (n + 1), a + (n + 1)
                faces.append((a, b, c))
                faces.append((a, c, d))
    return np.stack(verts).astype(np.float32), np.asarray(faces, np.int32)

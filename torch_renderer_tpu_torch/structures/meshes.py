"""Padded batched triangle meshes (PyTorch counterpart of
``torch_renderer_tpu.structures.meshes.Meshes``).

Ragged per-mesh lists become padded (B, V, 3) / (B, F, 3) tensors with valid
counts, so every batch item has the same shape and every op masks padding.

Padding invariants:
  * verts rows >= num_verts[b] are zeros;
  * faces rows >= num_faces[b] are (0, 0, 0): they reference a real vertex so
    gathers stay in bounds, and the face mask excludes them everywhere.

Faces are int64 (torch's index dtype). ``textures`` is a TexturesVertex,
a TexturesUV or None (white texels in shading); extend, to, update_padded
and offset_verts carry it along.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .._device import resolve_device
from .textures import TexturesUV, TexturesVertex

Textures = Union[TexturesVertex, TexturesUV]


def _pad_to(a: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n,) + a.shape[1:], dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


@dataclasses.dataclass(frozen=True)
class Meshes:
    verts: torch.Tensor      # (B, V, 3) float32, zero-padded
    faces: torch.Tensor      # (B, F, 3) int64, zero-padded
    num_verts: torch.Tensor  # (B,) int64
    num_faces: torch.Tensor  # (B,) int64
    textures: Optional[Textures] = None

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_lists(verts_list: Sequence, faces_list: Sequence,
                   device=None, textures: Optional[Textures] = None,
                   pad_verts_to: Optional[int] = None,
                   pad_faces_to: Optional[int] = None) -> "Meshes":
        """Build a padded batch from ragged per-mesh (Vi, 3)/(Fi, 3) arrays
        on ``device`` (default: the card, see _device.resolve_device), with
        optional textures (moved to that device). pad_verts_to /
        pad_faces_to fix the padded sizes (a static shape for every scene
        of a generator) in place of the largest mesh's."""
        device = resolve_device(device)
        verts_np = [np.asarray(v, np.float32) for v in verts_list]
        faces_np = [np.asarray(f, np.int64) for f in faces_list]
        V = pad_verts_to or max(v.shape[0] for v in verts_np)
        F = pad_faces_to or max(f.shape[0] for f in faces_np)
        return Meshes(
            verts=torch.as_tensor(np.stack([_pad_to(v, V) for v in verts_np]),
                                  device=device),
            faces=torch.as_tensor(np.stack([_pad_to(f, F) for f in faces_np]),
                                  device=device),
            num_verts=torch.tensor([v.shape[0] for v in verts_np],
                                   dtype=torch.int64, device=device),
            num_faces=torch.tensor([f.shape[0] for f in faces_np],
                                   dtype=torch.int64, device=device),
            textures=None if textures is None else textures.to(device),
        )

    @staticmethod
    def from_single(verts, faces, device=None,
                    textures: Optional[Textures] = None) -> "Meshes":
        return Meshes.from_lists([verts], [faces], device=device,
                                 textures=textures)

    # -- basic properties ---------------------------------------------------
    @property
    def batch_size(self) -> int:
        return self.verts.shape[0]

    @property
    def max_verts(self) -> int:
        return self.verts.shape[1]

    @property
    def max_faces(self) -> int:
        return self.faces.shape[1]

    @property
    def device(self) -> torch.device:
        return self.verts.device

    def vert_mask(self) -> torch.Tensor:
        """(B, V) float mask of valid vertices."""
        idx = torch.arange(self.max_verts, device=self.device)
        return (idx[None, :] < self.num_verts[:, None]).to(self.verts.dtype)

    def face_mask(self) -> torch.Tensor:
        """(B, F) float mask of valid faces."""
        idx = torch.arange(self.max_faces, device=self.device)
        return (idx[None, :] < self.num_faces[:, None]).to(self.verts.dtype)

    # -- batch ops ----------------------------------------------------------
    def __getitem__(self, idx) -> "Meshes":
        """Batch indexing (pytorch3d's Meshes[i]): an int (kept as a batch
        of 1), a slice (any step) or a sequence of ints. Every tensor, the
        textures' too, is indexed along the batch axis."""
        if isinstance(idx, (int, np.integer, slice)):
            idx = range(self.batch_size)[idx]
        idx = torch.as_tensor(idx, dtype=torch.long,
                              device=self.device).reshape(-1)

        def take(obj):
            return dataclasses.replace(obj, **{
                f.name: getattr(obj, f.name)[idx]
                for f in dataclasses.fields(obj)
                if isinstance(getattr(obj, f.name), torch.Tensor)})

        out = take(self)
        return out if self.textures is None else dataclasses.replace(
            out, textures=take(self.textures))

    def extend(self, n: int) -> "Meshes":
        """Repeat each mesh n times along the batch dim (item-major, like
        pytorch3d's Meshes.extend)."""
        def rep(a):
            # an expand, not repeat_interleave: no host read of the size
            return a.unsqueeze(1).expand((a.shape[0], n) + a.shape[1:]) \
                .reshape((a.shape[0] * n,) + a.shape[1:])

        return Meshes(verts=rep(self.verts), faces=rep(self.faces),
                      num_verts=rep(self.num_verts),
                      num_faces=rep(self.num_faces),
                      textures=None if self.textures is None
                      else self.textures.extend(n))

    def offset_verts(self, deform: torch.Tensor) -> "Meshes":
        """New mesh with verts + deform ((B, V, 3) or (V, 3)); padded
        vertices stay zero (pytorch3d's offset_verts)."""
        if deform.ndim == 2:
            deform = deform[None]
        return dataclasses.replace(
            self, verts=self.verts + deform * self.vert_mask()[..., None])

    def update_padded(self, new_verts: torch.Tensor) -> "Meshes":
        return dataclasses.replace(self, verts=new_verts)

    def scale(self, s, center=None) -> "Meshes":
        """Vertices scaled by s, about ``center`` when given (else the
        origin); padded vertices stay zero."""
        v = self.verts * s if center is None else \
            (self.verts - center) * s + center
        return dataclasses.replace(self, verts=v * self.vert_mask()[..., None])

    def to(self, device) -> "Meshes":
        return dataclasses.replace(
            self, verts=self.verts.to(device), faces=self.faces.to(device),
            num_verts=self.num_verts.to(device),
            num_faces=self.num_faces.to(device),
            textures=None if self.textures is None
            else self.textures.to(device))

    def detach_to_lists(self) -> List:
        """Host-side ragged (verts (Vi, 3), faces (Fi, 3)) numpy pairs, one
        per mesh (for IO)."""
        nv = self.num_verts.cpu().numpy()
        nf = self.num_faces.cpu().numpy()
        verts = self.verts.detach().cpu().numpy()
        faces = self.faces.cpu().numpy()
        return [(verts[b, :nv[b]], faces[b, :nf[b]])
                for b in range(self.batch_size)]

    # -- pytorch3d-style accessors -------------------------------------------
    def verts_padded(self) -> torch.Tensor:
        return self.verts

    def faces_padded(self) -> torch.Tensor:
        return self.faces

    def verts_list(self) -> List[np.ndarray]:
        return [v for v, _ in self.detach_to_lists()]

    def faces_list(self) -> List[np.ndarray]:
        return [f for _, f in self.detach_to_lists()]

    def verts_packed(self) -> torch.Tensor:
        """All valid vertices concatenated (V_total, 3), on the meshes'
        device (the ragged split reads the counts back to the host)."""
        nv = self.num_verts.tolist()
        return torch.cat([self.verts[b, :n] for b, n in enumerate(nv)])

    def get_mesh_verts_faces(self, index: int):
        """(verts (Vi, 3), faces (Fi, 3)) numpy arrays of one mesh."""
        return self.detach_to_lists()[index]

    def num_verts_per_mesh(self) -> torch.Tensor:
        return self.num_verts

    def num_faces_per_mesh(self) -> torch.Tensor:
        return self.num_faces

    # -- geometry -----------------------------------------------------------
    def face_verts(self) -> torch.Tensor:
        """Per-face corner positions (B, F, 3, 3), by indexed gather."""
        B, F, _ = self.faces.shape
        idx = self.faces.reshape(B, F * 3, 1).expand(B, F * 3, 3)
        return self.verts.gather(1, idx).reshape(B, F, 3, 3)

    def _face_cross(self) -> torch.Tensor:
        fv = self.face_verts()
        return torch.linalg.cross(fv[..., 1, :] - fv[..., 0, :],
                                  fv[..., 2, :] - fv[..., 0, :])

    def face_normals(self, normalize: bool = True) -> torch.Tensor:
        """(B, F, 3) face normals (zero for padded faces)."""
        n = self._face_cross()
        if normalize:
            n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-12)
        return n * self.face_mask()[..., None]

    def face_areas(self) -> torch.Tensor:
        """(B, F) triangle areas (zero for padded faces)."""
        return 0.5 * torch.linalg.norm(self._face_cross(), dim=-1) \
            * self.face_mask()

    def vertex_normals(self) -> torch.Tensor:
        """(B, V, 3) area-weighted vertex normals: each face's unnormalized
        normal is scatter-added at its three corners."""
        fn = self._face_cross() * self.face_mask()[..., None]   # (B, F, 3)
        B, F, _ = self.faces.shape
        idx = self.faces.transpose(1, 2).reshape(B, 3 * F, 1).expand(
            B, 3 * F, 3)                                         # corner-major
        vn = torch.zeros_like(self.verts).scatter_add(1, idx, fn.repeat(1, 3, 1))
        vn = vn / torch.linalg.norm(vn, dim=-1, keepdim=True).clamp_min(1e-12)
        return vn * self.vert_mask()[..., None]

    def bounding_boxes(self) -> torch.Tensor:
        """(B, 3, 2) per-mesh (min, max) over the valid vertices."""
        m = self.vert_mask()[..., None] > 0
        big = torch.tensor(1e30, dtype=self.verts.dtype, device=self.device)
        vmin = torch.where(m, self.verts, big).amin(1)
        vmax = torch.where(m, self.verts, -big).amax(1)
        return torch.stack([vmin, vmax], dim=-1)

    def center_and_scale_to_unit_sphere(self):
        """Normalize each mesh to fit the unit sphere: returns
        (meshes, center (B, 3), scale (B,))."""
        m = self.vert_mask()[..., None]
        nv = self.num_verts.to(self.verts.dtype).clamp_min(1)[:, None]
        center = (self.verts * m).sum(1) / nv
        centered = (self.verts - center[:, None, :]) * m
        scale = torch.linalg.norm(centered, dim=-1).amax(1).clamp_min(1e-12)
        out = dataclasses.replace(self, verts=centered / scale[:, None, None])
        return out, center, scale

"""Padded batched triangle meshes (PyTorch counterpart of
``torch_renderer_tpu.structures.meshes.Meshes``).

Ragged per-mesh lists become padded (B, V, 3) / (B, F, 3) tensors with valid
counts, so every batch item has the same shape and every op masks padding.

Padding invariants:
  * verts rows >= num_verts[b] are zeros;
  * faces rows >= num_faces[b] are (0, 0, 0): they reference a real vertex so
    gathers stay in bounds, and the face mask excludes them everywhere.

Faces are int64 (torch's index dtype). Textures are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


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

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_lists(verts_list: Sequence, faces_list: Sequence,
                   device=None) -> "Meshes":
        """Build a padded batch from ragged per-mesh (Vi, 3)/(Fi, 3) arrays."""
        verts_np = [np.asarray(v, np.float32) for v in verts_list]
        faces_np = [np.asarray(f, np.int64) for f in faces_list]
        V = max(v.shape[0] for v in verts_np)
        F = max(f.shape[0] for f in faces_np)
        return Meshes(
            verts=torch.as_tensor(np.stack([_pad_to(v, V) for v in verts_np]),
                                  device=device),
            faces=torch.as_tensor(np.stack([_pad_to(f, F) for f in faces_np]),
                                  device=device),
            num_verts=torch.tensor([v.shape[0] for v in verts_np],
                                   dtype=torch.int64, device=device),
            num_faces=torch.tensor([f.shape[0] for f in faces_np],
                                   dtype=torch.int64, device=device),
        )

    @staticmethod
    def from_single(verts, faces, device=None) -> "Meshes":
        return Meshes.from_lists([verts], [faces], device=device)

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
    def extend(self, n: int) -> "Meshes":
        """Repeat each mesh n times along the batch dim (item-major, like
        pytorch3d's Meshes.extend)."""
        def rep(a):
            return torch.repeat_interleave(a, n, dim=0)

        return Meshes(verts=rep(self.verts), faces=rep(self.faces),
                      num_verts=rep(self.num_verts),
                      num_faces=rep(self.num_faces))

    def update_padded(self, new_verts: torch.Tensor) -> "Meshes":
        return dataclasses.replace(self, verts=new_verts)

    def to(self, device) -> "Meshes":
        return Meshes(*(getattr(self, f.name).to(device)
                        for f in dataclasses.fields(self)))

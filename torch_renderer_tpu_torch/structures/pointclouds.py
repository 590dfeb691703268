"""Padded batched point clouds (PyTorch counterpart of
``torch_renderer_tpu.structures.pointclouds``): (B, P, 3) points with valid
counts, optional (B, P, C) per-point features, and the pytorch3d-style
accessors."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device


@dataclasses.dataclass(frozen=True)
class Pointclouds:
    points: torch.Tensor                     # (B, P, 3) float32, zero-padded
    num_points: torch.Tensor                 # (B,) int64
    features: Optional[torch.Tensor] = None  # (B, P, C) or None

    @staticmethod
    def from_lists(points_list: Sequence,
                   features_list: Optional[Sequence] = None,
                   pad_to: Optional[int] = None,
                   device=None) -> "Pointclouds":
        """Pad ragged (Pi, 3) arrays (and their (Pi, C) features) into one
        batch of pad_to (default: the largest cloud) points on ``device``
        (default: the card, see _device.resolve_device)."""
        device = resolve_device(device)
        pts = [np.asarray(p, np.float32) for p in points_list]
        P = pad_to or max(p.shape[0] for p in pts)

        def pad(a):
            out = np.zeros((P,) + a.shape[1:], np.float32)
            out[:a.shape[0]] = a
            return out

        feats = None
        if features_list is not None:
            feats = torch.as_tensor(np.stack(
                [pad(np.asarray(f, np.float32)) for f in features_list]),
                device=device)
        return Pointclouds(
            points=torch.as_tensor(np.stack([pad(p) for p in pts]),
                                   device=device),
            num_points=torch.tensor([p.shape[0] for p in pts],
                                    device=device),
            features=feats)

    @staticmethod
    def from_padded(points, num_points=None, features=None,
                    device=None) -> "Pointclouds":
        """Wrap padded (B, P, 3) (or (P, 3)) points; every point is valid
        unless num_points says otherwise. Tensors stay where they are;
        arrays go to ``device`` (default: the card)."""
        device = resolve_device(device, like=points)
        points = torch.as_tensor(points, dtype=torch.float32, device=device)
        if points.ndim == 2:
            points = points[None]
        if num_points is None:
            num_points = torch.full((points.shape[0],), points.shape[1],
                                    dtype=torch.int64, device=device)
        else:
            num_points = torch.as_tensor(num_points, dtype=torch.int64,
                                         device=device)
        if features is not None:
            features = torch.as_tensor(features, dtype=torch.float32,
                                       device=device)
        return Pointclouds(points=points, num_points=num_points,
                           features=features)

    @property
    def batch_size(self) -> int:
        return self.points.shape[0]

    @property
    def max_points(self) -> int:
        return self.points.shape[1]

    def mask(self) -> torch.Tensor:
        """(B, P) float validity mask."""
        idx = torch.arange(self.points.shape[1], device=self.points.device)
        return (idx[None] < self.num_points[:, None]).to(self.points.dtype)

    def extend(self, n: int) -> "Pointclouds":
        """Each cloud repeated n times in place (B -> B * n)."""
        def rep(a):
            return None if a is None else a.repeat_interleave(n, dim=0)

        return Pointclouds(rep(self.points), rep(self.num_points),
                           rep(self.features))

    def transform(self, R: torch.Tensor, t: torch.Tensor) -> "Pointclouds":
        """Batched rigid transform x' = R x + t (padding stays 0)."""
        p = torch.einsum("bij,bpj->bpi", R, self.points) + t[:, None, :]
        return dataclasses.replace(self, points=p * self.mask()[..., None])

    def centroids(self) -> torch.Tensor:
        """(B, 3) masked means."""
        m = self.mask()[..., None]
        n = self.num_points.to(self.points.dtype).clamp_min(1)[:, None]
        return (self.points * m).sum(1) / n

    def detach_to_lists(self) -> List[np.ndarray]:
        n = self.num_points.cpu().numpy()
        pts = self.points.detach().cpu().numpy()
        return [pts[b, :n[b]] for b in range(self.batch_size)]

    # pytorch3d-style accessors
    def points_padded(self) -> torch.Tensor:
        return self.points

    def points_list(self) -> List[np.ndarray]:
        return self.detach_to_lists()

    def num_points_per_cloud(self) -> torch.Tensor:
        return self.num_points

"""Padded batched point clouds (PyTorch counterpart of the part of
``torch_renderer_tpu.structures.pointclouds`` that the chamfer distance
needs): (B, P, 3) points with valid counts and a validity mask."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .._device import resolve_device


@dataclasses.dataclass(frozen=True)
class Pointclouds:
    points: torch.Tensor       # (B, P, 3) float32, zero-padded
    num_points: torch.Tensor   # (B,) int64

    @staticmethod
    def from_lists(points_list: Sequence, device=None) -> "Pointclouds":
        """Pad ragged (Pi, 3) arrays into one batch on ``device`` (default:
        the card, see _device.resolve_device)."""
        device = resolve_device(device)
        pts = [np.asarray(p, np.float32) for p in points_list]
        P = max(p.shape[0] for p in pts)
        padded = np.zeros((len(pts), P, 3), np.float32)
        for i, p in enumerate(pts):
            padded[i, :p.shape[0]] = p
        return Pointclouds(
            points=torch.as_tensor(padded, device=device),
            num_points=torch.tensor([p.shape[0] for p in pts], device=device))

    def mask(self) -> torch.Tensor:
        """(B, P) float validity mask."""
        idx = torch.arange(self.points.shape[1], device=self.points.device)
        return (idx[None] < self.num_points[:, None]).to(self.points.dtype)

"""Work of the untile (``csrc/untile.cu`` ``untile_kernel``), bytes only,
for each view of a scene: the four K = 1 fragment fields (face id as
int64, z, 3 barycentrics, distance: 28 bytes a pixel) read once for each
covered pixel (the reference depth render's) and written once for every
pixel."""

from __future__ import annotations

import torch

from reference.depth import depth


def per_view(scene: dict):
    """(operations (N,), bytes (N,)), float64."""
    H, W = scene["image_size"]
    d = depth(scene["verts"], scene["faces"], scene["K"], scene["R"],
              scene["t"], (H, W))
    covered = (d > 0).sum((1, 2)).double().cpu()
    return torch.zeros_like(covered), covered * 28 + H * W * 28

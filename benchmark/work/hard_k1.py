"""Work of the K = 1 selection (``csrc/hard_raster.cu`` ``hard_k1_kernel``)
for each view of a scene: OPS_HARD_K1 for each (pixel, valid face) pair
whose pixel centre lies in the face's raster box (a face covers no pixel
outside it); each valid face's corners and depths (9 floats) read once,
and the fragment (face id, z, 3 barycentrics, distance: 6 words) written
once for each pixel that lies in some face's box (the others have no
candidate to select from)."""

from __future__ import annotations

import torch

from benchlib.peaks import OPS_HARD_K1
from reference.geometry import box_pairs, project

PAIRS_PER_BLOCK = 1 << 24


def per_view(scene: dict):
    """(operations (N,), bytes (N,)), float64."""
    H, W = scene["image_size"]
    q, _, valid = project(scene["verts"], scene["faces"], scene["K"],
                          scene["R"], scene["t"], (H, W))
    N, F = valid.shape
    keep = valid.reshape(-1)
    q = q.reshape(N * F, 3, 2)[keep]
    view = torch.arange(N, device=q.device).repeat_interleave(F)[keep]
    pairs = torch.zeros(N, dtype=torch.float64, device=q.device)
    seen = torch.zeros(N * H * W, dtype=torch.bool, device=q.device)
    for f, row, col in box_pairs(q.amin(1), q.amax(1), (H, W),
                                 PAIRS_PER_BLOCK, margin=0):
        pairs.index_add_(0, view[f], torch.ones_like(f, dtype=torch.float64))
        seen[(view[f] * H + row) * W + col] = True
    boxed = seen.reshape(N, -1).sum(1).double()
    n_faces = valid.sum(1).double()
    return ((pairs * OPS_HARD_K1).cpu(),
            (n_faces * 36 + boxed * 24).cpu())

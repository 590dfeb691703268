"""The (pixel, face) pairs a soft silhouette needs, counted from the scene
(not from any binning): a pair is "full" when its term softplus(-signed
d2 / sigma) is not exactly +0.0 in float32 (x = -signed d2 / sigma at or
above peaks.SOFT_CUTOFF), and "edge" when it is not full but the pixel
centre lies in the face's raster box grown by sqrt(-SOFT_CUTOFF sigma),
so that the face's edge distances are needed to know it. The classes are
``chip_smoke.soft_fwd_bound``'s; pairs farther out count for nothing."""

from __future__ import annotations

import math

import torch

from benchlib.peaks import SOFT_CUTOFF
from reference.geometry import box_pairs, project
from reference.soft import signed_d2

PAIRS_PER_BLOCK = 1 << 22


def soft_pairs(scene: dict):
    """Per view of the scene: (full pairs (N,), edge pairs (N,), valid
    faces (N,)), float64 on the CPU."""
    H, W = scene["image_size"]
    s = min(H, W) / 2.0
    sigma = scene["config"]["sigma"]
    q, _, valid = project(scene["verts"], scene["faces"], scene["K"],
                          scene["R"], scene["t"], (H, W))
    N, F = valid.shape
    r = math.sqrt(-SOFT_CUTOFF * sigma)
    q = q.reshape(N * F, 3, 2)
    keep = valid.reshape(-1)
    view = torch.arange(N, device=q.device).repeat_interleave(F)[keep]
    q = q[keep]
    lo, hi = q.amin(1) - r, q.amax(1) + r
    full = torch.zeros(N, dtype=torch.float64, device=q.device)
    edge = torch.zeros_like(full)
    for f, row, col in box_pairs(lo, hi, (H, W), PAIRS_PER_BLOCK):
        px = ((col.double() + 0.5 - W / 2.0) / s).float()
        py = ((row.double() + 0.5 - H / 2.0) / s).float()
        box = ((px >= lo[f, 0]) & (px <= hi[f, 0]) & (py >= lo[f, 1])
               & (py <= hi[f, 1]))
        x = -signed_d2(px, py, q[f]) / sigma
        is_full = box & (x >= SOFT_CUTOFF)
        full.index_add_(0, view[f], is_full.double())
        edge.index_add_(0, view[f], (box & ~is_full).double())
    return full.cpu(), edge.cpu(), valid.sum(1).double().cpu()

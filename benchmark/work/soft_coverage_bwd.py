"""Work of the soft coverage backward (``csrc/soft_coverage.cu``
``soft_coverage_bwd_kernel``) for each view of a scene: OPS_SOFT_BWD a
full pair (the only pairs whose gradient is not exactly 0; _soft_pairs);
each valid face's six corners read and their gradient written once, each
pixel's cotangent read once."""

from __future__ import annotations

from benchlib.peaks import OPS_SOFT_BWD
from work._soft_pairs import soft_pairs


def per_view(scene: dict):
    """(operations (N,), bytes (N,)), float64."""
    H, W = scene["image_size"]
    full, _, faces = soft_pairs(scene)
    return full * OPS_SOFT_BWD, faces * 48 + H * W * 4

"""Work of the soft coverage forward (``csrc/soft_coverage.cu``
``soft_coverage_fwd_kernel``) for each view of a scene: OPS_SOFT_FWD a
full pair and OPS_SOFT_EDGE an edge pair (_soft_pairs); each valid face's
six raster corners read once and each pixel's sum S written once."""

from __future__ import annotations

from benchlib.peaks import OPS_SOFT_EDGE, OPS_SOFT_FWD
from work._soft_pairs import soft_pairs


def per_view(scene: dict):
    """(operations (N,), bytes (N,)), float64."""
    H, W = scene["image_size"]
    full, edge, faces = soft_pairs(scene)
    return full * OPS_SOFT_FWD + edge * OPS_SOFT_EDGE, faces * 24 + H * W * 4

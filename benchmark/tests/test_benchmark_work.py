"""The rooflines' work counts against brute force: every (pixel, face)
pair of a small scene visited, none skipped by a box."""

import math

import pytest
import torch

from benchlib import peaks, scene as scenes
from reference.depth import depth
from reference.geometry import pixel_centres, project
from reference.soft import signed_d2
from work import hard_k1, soft_coverage_bwd, soft_coverage_fwd, untile

SOFT = {"cameras": "turntable", "level": 1, "views": 3, "image": [40, 56],
        "focal_scale": 0.8, "distance": 3.0, "sigma": 1e-3,
        "displacement": 0.05}
DEPTH = {"cameras": "orbit", "level": 2, "views": 3, "image": [36, 64],
         "focal_scale": 0.9, "distance": 2.7, "elevation": 15.0, "bin": 8,
         "displacement": 0.05}


def _brute(scene):
    """Per view: (full, edge, box pairs, pixels in some box, valid faces)
    over every (pixel, face) pair."""
    H, W = scene["image_size"]
    sigma = scene["config"].get("sigma", 1e-4)
    q, _, valid = project(scene["verts"], scene["faces"], scene["K"],
                          scene["R"], scene["t"], (H, W))
    p = pixel_centres((H, W), q.device)                  # (P, 2)
    px, py = p[None, :, None, 0], p[None, :, None, 1]
    x = -signed_d2(px, py, q[:, None]) / sigma            # (N, P, F)
    r = math.sqrt(-peaks.SOFT_CUTOFF * sigma)
    lo, hi = q.amin(2)[:, None], q.amax(2)[:, None]       # (N, 1, F, 2)

    def inbox(m):
        return ((px >= lo[..., 0] - m) & (px <= hi[..., 0] + m)
                & (py >= lo[..., 1] - m) & (py <= hi[..., 1] + m)
                & valid[:, None])

    grown, box = inbox(r), inbox(0.0)
    full = grown & (x >= peaks.SOFT_CUTOFF)
    edge = grown & ~full
    return (full.sum((1, 2)).double(), edge.sum((1, 2)).double(),
            box.sum((1, 2)).double(), box.any(2).sum(1).double(),
            valid.sum(1).double())


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_soft_counts_match_brute_force(seed):
    scene = scenes.make_scene(SOFT, seed, 3, "cpu")
    H, W = scene["image_size"]
    full, edge, _, _, faces = _brute(scene)
    assert float(full.sum()) > 0 and float(edge.sum()) > 0
    ops, nbytes = soft_coverage_fwd.per_view(scene)
    assert torch.equal(ops, full * peaks.OPS_SOFT_FWD
                       + edge * peaks.OPS_SOFT_EDGE)
    assert torch.equal(nbytes, faces * 24 + H * W * 4)
    ops, nbytes = soft_coverage_bwd.per_view(scene)
    assert torch.equal(ops, full * peaks.OPS_SOFT_BWD)
    assert torch.equal(nbytes, faces * 48 + H * W * 4)


@pytest.mark.parametrize("seed", [5, 2**31 + 13])
def test_hard_counts_match_brute_force(seed):
    scene = scenes.make_scene(DEPTH, seed, 3, "cpu")
    H, W = scene["image_size"]
    _, _, box, boxed, faces = _brute(scene)
    ops, nbytes = hard_k1.per_view(scene)
    assert torch.equal(ops, box * peaks.OPS_HARD_K1)
    assert torch.equal(nbytes, faces * 36 + boxed * 24)
    ops, nbytes = untile.per_view(scene)
    covered = (depth(scene["verts"], scene["faces"], scene["K"], scene["R"],
                     scene["t"], (H, W)) > 0).sum((1, 2)).double()
    assert float(covered.min()) > 0
    assert torch.equal(ops, torch.zeros(3, dtype=torch.float64))
    assert torch.equal(nbytes, covered * 28 + H * W * 28)

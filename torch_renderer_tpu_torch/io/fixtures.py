"""Recorded sensor-data fixture ingestion (filtered_datas.pkl-style); the
port's own copy of ``torch_renderer_tpu.io.fixtures`` (numpy only).

The reference's pose-fit and renderer-comparison workloads consume recorded
RGBD pickles: a list of dicts with object_id, object_pose (4,4),
extrinsic (4,4), intrinsic (3,3), rendered_depth (H, W)
(pose_optimizer.py:41-61, renderer_comparison_with_pyrender.py:108-127,
SURVEY.md §2b). This module loads that format into batched arrays ready for
DepthPoseFitter / MeshRenderer, computing the per-frame camera chain
cam = extrinsic @ object_pose the way the reference does
(pose_optimizer.py:91).
"""

from __future__ import annotations

import pickle
from typing import Dict, List

import numpy as np


def load_recorded_frames(path: str) -> Dict[str, np.ndarray]:
    """Load a filtered_datas.pkl-style list into stacked arrays.

    Returns dict with:
      K (N, 3, 3), extrinsic (N, 4, 4), object_pose (N, 4, 4),
      depth (N, H, W), object_id (N,),
      R / t (N, 3, 3)/(N, 3): OpenCV extrinsics of the full chain
      world(object frame) -> camera, i.e. extrinsic @ object_pose.
    """
    with open(path, "rb") as f:
        frames: List[dict] = pickle.load(f)
    if not isinstance(frames, (list, tuple)):
        frames = [frames]

    K = np.stack([np.asarray(fr["intrinsic"], np.float32) for fr in frames])
    ext = np.stack([np.asarray(fr["extrinsic"], np.float32) for fr in frames])
    pose = np.stack(
        [np.asarray(fr.get("object_pose", np.eye(4)), np.float32) for fr in frames]
    )
    depth = np.stack(
        [np.asarray(fr["rendered_depth"], np.float32) for fr in frames]
    )
    obj_id = np.asarray(
        [int(fr.get("object_id", -1)) for fr in frames], np.int32
    )

    chain = np.einsum("nij,njk->nik", ext, pose)
    return {
        "K": K, "extrinsic": ext, "object_pose": pose, "depth": depth,
        "object_id": obj_id, "R": chain[:, :3, :3], "t": chain[:, :3, 3],
    }


def save_recorded_frames(path: str, frames: List[dict]) -> None:
    """Write frames in the reference's pickle format (for tests/tools)."""
    with open(path, "wb") as f:
        pickle.dump(frames, f)

"""Helpers shared by the port's apps (counterpart of the JAX package's
``apps/_common.py``): the pinhole intrinsics and the scene mesh."""

from __future__ import annotations

import numpy as np


def pinhole_K(image_size, focal_scale: float = 0.9) -> np.ndarray:
    """(3, 3) pinhole matrix: focal focal_scale * min(H, W), principal
    point at the image center."""
    H, W = image_size
    f = focal_scale * min(H, W)
    return np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]],
                    np.float32)


def load_scene_mesh(args, level: int = 3, normalize: bool = True):
    """Meshes (B=1) on args.device from args.obj, or a generated level-
    ``level`` icosphere; normalized to the unit sphere unless told not
    to."""
    from ..ops.icosphere import icosphere
    from ..structures.meshes import Meshes

    if args.obj:
        from ..io.obj import load_objs_as_meshes

        meshes = load_objs_as_meshes([args.obj], device=args.device)
    else:
        meshes = Meshes.from_single(*icosphere(level), device=args.device)
    if normalize:
        meshes, _, _ = meshes.center_and_scale_to_unit_sphere()
    return meshes

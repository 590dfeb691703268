"""Helpers shared by the port's apps (counterpart of the JAX package's
``apps/_common.py``): the common CLI options, the pinhole intrinsics and the
scene mesh."""

from __future__ import annotations

import argparse

import numpy as np


def base_parser(description: str) -> argparse.ArgumentParser:
    """The options every app of the JAX package shares, with --device (the
    torch device; default cuda, which raises without a card) in place of
    --cpu."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda",
                   help="torch device: cpu, cuda or cuda:N")
    p.add_argument("--obj", type=str, default=None, help="input OBJ mesh path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--check-budgets", nargs="?", const="warn", default="warn",
                   choices=["warn", "off"],
                   help="'warn' (default) reads every silent-drop budget's "
                        "true count back once per call and warns on "
                        "overflow; 'off' disables the checks (benching)")
    return p


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

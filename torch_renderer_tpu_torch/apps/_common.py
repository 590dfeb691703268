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


def add_eager_option(p: argparse.ArgumentParser, what: str) -> None:
    """--eager, for an app whose loop or calls run as replays of captured
    CUDA graphs on the card (utils/graph.py): run what (e.g. "each
    iteration") op by op instead."""
    p.add_argument("--eager", action="store_true",
                   help=f"run {what} op by op, not as a replay of a "
                        "captured CUDA graph")


def app_capture(args):
    """The capture= argument --eager gives (utils/graph.resolve_capture):
    False, or None (captured on the card, eager on the CPU)."""
    return False if args.eager else None


def resolve_app_device(args):
    """The app's torch device, from --device (RuntimeError for a CUDA
    device when no card is present: there is no fallback); also sets the
    process-wide budget-check default from --check-budgets."""
    import torch

    from ..rasterize.binning import set_budget_check_default

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "available")
    set_budget_check_default(args.check_budgets)
    return device


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


def parse_mesh_shape(text: str) -> tuple:
    """'d,m' -> (d, m), as the JAX apps parse --mesh-shape."""
    return tuple(int(s) for s in text.split(","))


def describe_mesh(device_mesh) -> str:
    """'device mesh {'data': d, 'model': m} over n ranks'."""
    shape = dict(zip(device_mesh.mesh_dim_names, device_mesh.shape))
    return f"device mesh {shape} over {device_mesh.size()} ranks"


def _mesh_rank(run, args, shape):
    """One rank of run_on_mesh: the mesh, and rank 0's printout alone."""
    import contextlib
    import io

    import torch.distributed as dist

    from ..parallel.mesh import make_mesh

    device_mesh = make_mesh(shape)
    quiet = dist.get_rank() != 0
    with contextlib.redirect_stdout(io.StringIO()) if quiet \
            else contextlib.nullcontext():
        return run(args, device_mesh)


def run_on_mesh(run, args, shape):
    """run(args, device_mesh) on a (d, m) mesh of ranks; rank 0's result.

    Under torchrun (RANK and WORLD_SIZE set) the ranks are the group it
    gives. Otherwise parallel.launch.run_ranks starts d * m of them on
    --device, with its default backend (NCCL with one card a rank where
    there are enough cards, gloo otherwise); a world of one runs in this
    process. Only rank 0 prints."""
    import numpy as np
    import torch.distributed as dist

    from ..parallel.launch import default_backend, init_from_env, run_ranks

    if init_from_env() or dist.is_initialized():
        return _mesh_rank(run, args, shape)
    world = int(np.prod(shape))
    return run_ranks(_mesh_rank, world, default_backend(world, args.device),
                     run, args, shape)[0]

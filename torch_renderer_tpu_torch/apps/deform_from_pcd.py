"""Mesh deformation demo: a sphere deformed into a target by the chamfer
distance plus regularizers. The PyTorch port's counterpart of the JAX
package's apps/deform_from_pcd.py (the reference's deform_mesh_from_pcd.py:
SGD lr 1.0 momentum 0.9, weights 1.0 / 1.0 / 0.01 / 0.1, periodic OBJ
snapshots), with its CLI and printout and --device in place of --cpu.

  python -m torch_renderer_tpu_torch.apps.deform_from_pcd --iters 2000
  python -m torch_renderer_tpu_torch.apps.deform_from_pcd --device cpu --iters 50 --level 2

The default target is the level-``--level`` icosphere scaled by
(1, 0.6, 0.4). Saves the snapshots and geometry_result.obj under --out-dir.
The default --device cuda raises when no CUDA device is present (there is
no fallback); pass --device cpu to run on the CPU.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="torch device: cpu, cuda or cuda:N")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--target-obj", type=str, default=None,
                   help="target mesh OBJ (default: generated ellipsoid)")
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--samples", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1.0)
    p.add_argument("--snapshot-every", type=int, default=500)
    p.add_argument("--out-dir", type=str, default="deform_out")
    p.add_argument("--level", type=int, default=4,
                   help="icosphere subdivision of the source (4 = 2562 "
                        "verts)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "available")

    from ..io.obj import load_objs_as_meshes, save_obj
    from ..ops.icosphere import icosphere
    from ..opt.deform import DeformConfig, MeshDeformer
    from ..structures.meshes import Meshes

    verts, faces = icosphere(args.level)
    src = Meshes.from_single(verts, faces, device=device)
    if args.target_obj:
        tgt = load_objs_as_meshes([args.target_obj], device=device)
        tgt, _, _ = tgt.center_and_scale_to_unit_sphere()
    else:
        tgt = Meshes.from_single(
            verts * np.array([1.0, 0.6, 0.4], np.float32), faces,
            device=device)

    cfg = DeformConfig(n_samples=args.samples, lr=args.lr,
                       n_steps=args.iters)
    deformer = MeshDeformer(src, target_meshes=tgt, config=cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    mesh, _, hist, snaps = deformer.fit(gen,
                                        snapshot_every=args.snapshot_every)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0

    cham = hist["chamfer"].cpu().numpy()
    print(f"chamfer: {cham[0]:.5f} -> {cham[-1]:.5f}")
    print(f"{args.iters} iters in {elapsed:.2f}s = "
          f"{args.iters / elapsed:.1f} iters/sec")
    os.makedirs(args.out_dir, exist_ok=True)
    for i, s in enumerate(snaps):
        v, f = s.detach_to_lists()[0]
        save_obj(os.path.join(args.out_dir, f"snapshot_{i:03d}.obj"), v, f)
    v, f = mesh.detach_to_lists()[0]
    out = os.path.join(args.out_dir, "geometry_result.obj")
    save_obj(out, v, f)
    print("saved", out)
    return cham


if __name__ == "__main__":
    main()

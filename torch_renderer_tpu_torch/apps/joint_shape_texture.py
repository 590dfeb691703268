"""Joint shape + UV-texture optimization from multi-view renders: the
PyTorch port's counterpart of the JAX package's apps/joint_shape_texture.py
(the reference's deform_mesh_with_color.py), with its CLI and printout and
--device in place of --cpu.

Renders a 15-view RGB / silhouette dataset of a target (by default a level-4
icosphere scaled by (1, 0.7, 0.9) with a striped 128x128 UV texture), then
fits per-vertex offsets of the plain icosphere and a 256x256 texture map
together; prints the silhouette and RGB MSE (mean of the first 20 steps ->
mean of the last 20) and iterations per second, and writes
result_colored.obj with its MTL and PNG.

  python -m torch_renderer_tpu_torch.apps.joint_shape_texture --iters 500
  python -m torch_renderer_tpu_torch.apps.joint_shape_texture --device cpu --iters 20 --image-size 48 --level 2

The default --device cuda raises when no CUDA device is present (there is
no fallback); pass --device cpu to run on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from ._common import pinhole_K


def striped_target(verts: np.ndarray, faces: np.ndarray, verts_uvs, device):
    """The default target: the sphere scaled by (1, 0.7, 0.9) with a
    128x128 map, red 0.8 everywhere and green 0.9 on every 16th row."""
    from ..structures.meshes import Meshes
    from ..structures.textures import TexturesUV

    tex = np.zeros((128, 128, 3), np.float32)
    tex[:, :, 0] = 0.8
    tex[::16, :, 1] = 0.9
    tgt = Meshes.from_single(verts * np.array([1.0, 0.7, 0.9], np.float32),
                             faces, device=device)
    return dataclasses.replace(tgt, textures=TexturesUV(
        maps=torch.as_tensor(tex, device=device)[None],
        faces_uvs=tgt.faces[:1],
        verts_uvs=torch.as_tensor(verts_uvs, device=device)[None]))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="torch device: cpu, cuda or cuda:N")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--check-budgets", nargs="?", const="warn", default="warn",
                   choices=["warn", "off"],
                   help="'warn' (default) reads every silent-drop budget's "
                        "true count back once per call and warns on "
                        "overflow; 'off' disables the checks (benching)")
    p.add_argument("--target-obj", type=str, default=None)
    p.add_argument("--image-size", type=int, default=128)
    p.add_argument("--views", type=int, default=15)
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--texture-size", type=int, default=256)
    p.add_argument("--level", type=int, default=4)
    p.add_argument("--out-dir", type=str, default="joint_out")
    p.add_argument("--active-tiles", type=int, default=-1,
                   help="-1 = auto-size tile compaction (default), 0 = off, "
                        ">0 = fixed budget")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "available")

    from ..io.obj import load_objs_as_meshes, save_obj
    from ..ops.icosphere import icosphere
    from ..opt.deform_color import JointFitConfig, JointShapeTextureFitter
    from ..rasterize.binning import set_budget_check_default
    from ..structures.meshes import Meshes
    from ..structures.textures import sphere_uv_mapping

    set_budget_check_default(args.check_budgets)
    H = W = args.image_size
    verts, faces = icosphere(args.level)
    src = Meshes.from_single(verts, faces, device=device)
    verts_uvs = torch.as_tensor(sphere_uv_mapping(verts), device=device)
    if args.target_obj:
        tgt = load_objs_as_meshes([args.target_obj], device=device)
        tgt, _, _ = tgt.center_and_scale_to_unit_sphere()
    else:
        tgt = striped_target(verts, faces, verts_uvs, device)

    cfg = JointFitConfig(
        n_views=args.views, n_steps=args.iters,
        texture_size=args.texture_size,
        active_tiles=None if args.active_tiles < 0 else args.active_tiles)
    fitter = JointShapeTextureFitter(pinhole_K((H, W)), (H, W), cfg,
                                     device=device)
    dataset = fitter.make_dataset(tgt)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # a few throwaway steps build the kernels and warm the allocator, so
    # the timed run reports steady-state throughput
    t0 = time.perf_counter()
    fitter.fit(src, verts_uvs, dataset,
               torch.Generator().manual_seed(args.seed + 1),
               n_steps=min(args.iters, 5))
    sync()
    warm_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    params, hist = fitter.fit(src, verts_uvs, dataset,
                              torch.Generator().manual_seed(args.seed))
    sync()
    elapsed = time.perf_counter() - t0

    sil = hist["sil_mse"].cpu().numpy()
    rgb = hist["rgb_mse"].cpu().numpy()
    print(f"sil MSE {sil[:20].mean():.5f} -> {sil[-20:].mean():.5f}; "
          f"rgb MSE {rgb[:20].mean():.5f} -> {rgb[-20:].mean():.5f}")
    print(f"{args.iters} iters in {elapsed:.1f}s = "
          f"{args.iters / elapsed:.1f} iters/sec steady "
          f"(one-time build+warmup {warm_s:.1f}s)")

    os.makedirs(args.out_dir, exist_ok=True)
    final = fitter.textured_mesh(src, verts_uvs, params)
    v, f = final.detach_to_lists()[0]
    out = os.path.join(args.out_dir, "result_colored.obj")
    save_obj(out, v, f, verts_uvs=verts_uvs.cpu().numpy(), faces_uvs=f,
             texture_image=params["texture_map"].cpu().numpy())
    print("saved", out)
    return sil, rgb, params


if __name__ == "__main__":
    main()

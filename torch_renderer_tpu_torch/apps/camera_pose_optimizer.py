"""Camera pose optimization demo: the analysis-by-synthesis loop of the
PyTorch port, with the CLI and printout of the JAX package's
apps/camera_pose_optimizer.py.

Renders reference depth / silhouette / RGB of a level-3 icosphere
(normalized to the unit sphere) at look_at(2.7, 15, 40), perturbs the
camera translation by perturb_t * N(0, 1) from the seed, and fits the
7-DoF camera with Adam; prints the loss, IoU and translation error at the
start and end, and iterations per second.

  python -m torch_renderer_tpu_torch.apps.camera_pose_optimizer
  python -m torch_renderer_tpu_torch.apps.camera_pose_optimizer --device cpu --iters 100

The default --device cuda raises when no CUDA device is present (there is
no fallback); pass --device cpu to run on the CPU.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ._common import (
    base_parser,
    load_scene_mesh,
    pinhole_K,
    resolve_app_device,
)


def parse_args(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--image-size", type=int, default=128)
    p.add_argument("--iters", type=int, default=500)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--no-rgb", action="store_true")
    p.add_argument("--occlusion", action="store_true",
                   help="patch-occlude the reference depth (robustness test)")
    p.add_argument("--perturb-t", type=float, default=0.1)
    p.add_argument("--bin-size", type=int, default=None,
                   help="coarse-to-fine rasterizer tile size (e.g. 16); "
                        "default auto")
    p.add_argument("--max-faces-per-bin", type=int, default=128)
    p.add_argument("--silhouette-impl", choices=["fragments", "pallas"],
                   default="fragments",
                   help="'pallas' = exact all-faces soft-coverage kernel "
                        "silhouette + K=1 fragments")
    p.add_argument("--active-tiles", type=int, default=-1,
                   help="tile-compaction budget for the binned rasterizer "
                        "and the soft silhouette; -1 = auto-size from GT and "
                        "start poses with 2x margin, 0 = off")
    p.add_argument("--select-impl", choices=["auto", "affine"],
                   default="auto",
                   help="accepted for CLI parity; the port has one K=1 "
                        "selection kernel")
    p.add_argument("--sil-layout", choices=["lane", "packed"], default="lane",
                   help="soft-silhouette layout ('packed' auto-sizes its "
                        "budgets from GT and start poses with 2x margin)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_app_device(args)

    from ..cameras.look_at import look_at_view_transform
    from ..cameras.perspective import PerspectiveCamera
    from ..opt.pose_fit import (
        CameraPoseFitter,
        PoseFitConfig,
        pose_params_from_Rt,
        pose_params_to_Rt,
    )
    from ..rasterize.binning import suggest_active_tiles_fd, tile_grid
    from ..rasterize.geometry import setup_faces

    H = W = args.image_size
    meshes = load_scene_mesh(args)
    K = pinhole_K((H, W))
    R_gt, t_gt = look_at_view_transform(2.7, 15.0, 40.0)
    R_gt, t_gt = R_gt[0].numpy(), t_gt[0].numpy()

    rng = np.random.default_rng(args.seed)
    t0_ = t_gt + args.perturb_t * rng.standard_normal(3).astype(np.float32)

    act = None if args.active_tiles == 0 else args.active_tiles
    sil_act = act if act and act > 0 else None
    need_auto_act = act is not None and act < 0
    need_sil_cfg = args.sil_layout == "packed"

    # project once at both poses the fit traverses (GT and the perturbed
    # start); every budget below is sized from both with 2x margin
    fds = None
    if need_auto_act or need_sil_cfg:
        with torch.no_grad():
            fds = [setup_faces(meshes, PerspectiveCamera.from_K(
                K, (H, W), R=Rp[None], t=tp_[None], device=device))
                for Rp, tp_ in ((R_gt, t_gt), (R_gt, t0_))]

    if need_auto_act:
        tile = args.bin_size or 16
        need = max(suggest_active_tiles_fd(fd, (H, W), tile, 0.0, margin=2.0)
                   for fd in fds)
        TH, TW, _ = tile_grid((H, W), tile)
        act = need if need < TH * TW else None
        sil_act = act
        print(f"auto active_tiles = {act}")

    sil_cfg = None
    if need_sil_cfg:
        from ..rasterize.cuda_soft import suggest_soft_config

        sil_cfg = suggest_soft_config(fds, (H, W), margin=2.0,
                                      layout="packed")
        if sil_act is not None:
            sil_cfg = sil_cfg._replace(active_tiles=sil_act)
        print(f"auto sil config = {sil_cfg}")

    cfg = PoseFitConfig(lr=args.lr, n_steps=args.iters,
                        use_rgb=not args.no_rgb)
    fitter = CameraPoseFitter(
        K, (H, W), cfg, bin_size=args.bin_size,
        max_faces_per_bin=args.max_faces_per_bin,
        silhouette_impl=args.silhouette_impl, sil_active_tiles=sil_act,
        sil_layout=args.sil_layout, sil_config=sil_cfg,
        active_tiles=act if args.bin_size else None,
        select_impl=args.select_impl, device=device,
    )
    occ = (torch.Generator().manual_seed(args.seed) if args.occlusion
           else None)
    refs = fitter.make_references(meshes, R_gt, t_gt,
                                  occlusion_generator=occ)
    params0 = pose_params_from_Rt(R_gt, t0_, device)

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_start = time.perf_counter()
    params, hist = fitter.fit(meshes, refs, params0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t_start

    losses = hist["loss"].cpu().numpy()
    ious = hist["iou"].cpu().numpy()
    _, t_fit = pose_params_to_Rt(params)
    err0 = float(np.linalg.norm(t0_ - t_gt))
    err1 = float(np.linalg.norm(t_fit[0].cpu().numpy() - t_gt))
    print(f"loss: {losses[0]:.5f} -> {losses[-1]:.5f}   iou: {ious[0]:.3f} "
          f"-> {ious[-1]:.3f}")
    print(f"translation error: {err0:.4f} -> {err1:.4f} m")
    print(f"{args.iters} iters in {elapsed:.2f}s (incl. compile) = "
          f"{args.iters / elapsed:.1f} iters/sec")
    return losses, ious, err0, err1


if __name__ == "__main__":
    main()

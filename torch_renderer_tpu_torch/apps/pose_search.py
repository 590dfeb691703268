"""GMM cross-entropy global pose search (and an optional ICP refinement),
in the PyTorch port, with the CLI and printout of the JAX package's
apps/pose_search.py (the reference's pytorch3d_icp_evaluation.py,
ICPTensorEvalutor :117-341).

A ground-truth pose is drawn, the reference cloud moved by it is the
target, and SE(3) is searched with chamfer-scored GMM resampling on the
device (on the card each EM iteration is a replay of a captured CUDA
graph; the reference goes to sklearn on the host every iteration).
Without --obj the cloud comes from the level-3 icosphere, squashed and
given an off-axis lobe so that the rotation is observable. --refine runs
50 ICP steps from the found pose; --batch N searches N more targets at
once; --plot-dir writes the per-iteration scatter + GMM ellipse PNGs
(needs matplotlib).

  python -m torch_renderer_tpu_torch.apps.pose_search
  python -m torch_renderer_tpu_torch.apps.pose_search --device cpu --points 128 --hypotheses 64 --elite 16 --iters 4

The default --device cuda raises when no CUDA device is present (there is
no fallback); pass --device cpu to run on the CPU. --mesh-shape (sharding
the hypotheses over several cards) waits for ROADMAP Queue 1 item 24.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ._common import base_parser, load_scene_mesh, resolve_app_device


def write_iteration_plots(plot_dir: str, out, gt_t=None) -> None:
    """Per-EM-iteration hypothesis scatter + GMM ellipse overlay PNGs
    (translation x/y), the reference's PUResults diagnostic
    (pytorch3d_icp_evaluation.py:244-279 saves one per EM iteration)."""
    from types import SimpleNamespace

    from ..utils.plotting import _pyplot, plot_gmm_ellipses

    plt = _pyplot()
    plt.switch_backend("Agg")
    os.makedirs(plot_dir, exist_ok=True)
    poses, scores, means, var, weights = (
        out[k].cpu().numpy() for k in ("iter_poses", "iter_scores",
                                       "gmm_means", "gmm_var",
                                       "gmm_weights"))
    for i in range(poses.shape[0]):
        _, ax = plt.subplots(figsize=(5, 5))
        plot_gmm_ellipses(SimpleNamespace(means=means[i], var=var[i],
                                          weights=weights[i]), ax=ax)
        sc = ax.scatter(poses[i, :, 0], poses[i, :, 1], c=scores[i], s=6,
                        cmap="viridis")
        plt.colorbar(sc, ax=ax, label="chamfer")
        if gt_t is not None:
            g = np.asarray(gt_t)
            ax.plot(g[0], g[1], "r*", markersize=12, label="gt")
            ax.legend(loc="upper right")
        ax.set_xlabel("t_x")
        ax.set_ylabel("t_y")
        ax.set_title(f"EM iter {i}: best {float(np.min(scores[i])):.4f}")
        plt.savefig(os.path.join(plot_dir, f"em_iter_{i:02d}.png"), dpi=110,
                    bbox_inches="tight")
        plt.close()
    print(f"wrote {poses.shape[0]} EM-iteration plots to {plot_dir}/")


def parse_args(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--points", type=int, default=500)
    p.add_argument("--hypotheses", type=int, default=400)
    p.add_argument("--elite", type=int, default=100)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--refine", action="store_true",
                   help="ICP-refine the result")
    p.add_argument("--batch", type=int, default=0,
                   help="also search N targets at once (serving-scale "
                        "demo)")
    p.add_argument("--mesh-shape", type=str, default=None,
                   help="'d,m' device-mesh shape: shard the hypotheses "
                        "(not ported yet: ROADMAP Queue 1 item 24)")
    p.add_argument("--plot-dir", type=str, default=None,
                   help="write a per-EM-iteration hypothesis scatter + GMM "
                        "ellipse overlay PNG (the reference's PUResults "
                        "diagnostic, pytorch3d_icp_evaluation.py:244-279)")
    return p.parse_args(argv)


def app_cloud(meshes, n_points: int, generator, lobe: bool):
    """The app's reference cloud: n_points sampled from meshes; with lobe
    (the generated icosphere, which is rotationally symmetric) squashed
    by (1, 0.6, 0.35) and a sixth of the points moved by (0.7, 0.3, 0)
    (the reference uses asymmetric YCB objects)."""
    import torch

    from ..ops.sample_points import sample_points_from_meshes

    ref = sample_points_from_meshes(meshes, n_points, generator)[0]
    if lobe:
        ref = ref * ref.new_tensor([1.0, 0.6, 0.35])
        shift = torch.zeros_like(ref)
        shift[: n_points // 6] = ref.new_tensor([0.7, 0.3, 0.0])
        ref = ref + shift
    return ref


def app_scene(args, device):
    """(generator, reference cloud, gt_R, gt_t, target): the app's cloud
    and a ground-truth pose with rpy uniform in [-0.8, 0.8] and t = (0.15,
    -0.1, 0.2), from one generator on ``device`` seeded with --seed (the
    search draws from it next)."""
    import torch

    from ..transforms.so3 import euler_angles_to_matrix, transform_points

    meshes = load_scene_mesh(args)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    ref = app_cloud(meshes, args.points, gen, args.obj is None)
    gt_rpy = torch.rand(3, generator=gen, device=device) * 1.6 - 0.8
    gt_t = torch.tensor([0.15, -0.1, 0.2], device=device)
    gt_R = euler_angles_to_matrix(gt_rpy, "XYZ")
    return gen, ref, gt_R, gt_t, transform_points(gt_R, gt_t, ref)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_app_device(args)
    if args.mesh_shape:
        raise NotImplementedError(
            "--mesh-shape needs the port's parallel/ (torch.distributed), "
            "ROADMAP Queue 1 item 24")

    import torch

    from ..ops.icp import SimilarityTransform, iterative_closest_point
    from ..ops.knn_chamfer import chamfer_distance
    from ..opt.pose_search import GMMPoseSearch, PoseSearchConfig, \
        pose_errors
    from ..transforms.so3 import euler_angles_to_matrix, transform_points
    from ..utils.timing import synchronize

    gen, ref, gt_R, gt_t, target = app_scene(args, device)

    cfg = PoseSearchConfig(n_hypotheses=args.hypotheses,
                           n_elite=args.elite, n_iters=args.iters)
    searcher = GMMPoseSearch(ref, cfg)
    t0 = time.perf_counter()
    out = searcher.search(gen, target)
    synchronize(out["score"])
    elapsed = time.perf_counter() - t0

    terr, rerr = pose_errors(out["pose6d"][None], gt_R, gt_t)
    hist = out["best_history"].cpu().numpy()
    print(f"search: {args.iters} EM iters x {args.hypotheses} hypotheses in "
          f"{elapsed:.2f}s (first call); best chamfer "
          f"{float(out['score']):.5f}")
    print(f"pose error: trans {float(terr[0]):.4f} m, "
          f"rot {np.degrees(float(rerr[0])):.2f} deg")
    print("best-score history:", np.array2string(hist, precision=4))
    res = {"score": float(out["score"]), "trans_err": float(terr[0]),
           "rot_err": float(rerr[0]), "best_history": hist,
           "seconds": elapsed}

    if args.plot_dir:
        write_iteration_plots(args.plot_dir, out, gt_t.cpu().numpy())

    if args.refine:
        init = SimilarityTransform(R=out["R"][None], t=out["t"][None],
                                   s=torch.ones(1, device=device))
        sol = iterative_closest_point(ref[None], target[None],
                                      init_transform=init,
                                      max_iterations=50)
        cham, _ = chamfer_distance(sol.Xt, target[None])
        print(f"after ICP refinement: surface chamfer {float(cham):.6f}, "
              f"rmse {float(sol.rmse[0]):.6f}")
        res["refined_chamfer"] = float(cham)

    if args.batch:
        B = args.batch
        gb = torch.Generator(device=device).manual_seed(args.seed + 1)
        rpys = torch.rand((B, 3), generator=gb, device=device) * 1.6 - 0.8
        tb = torch.rand((B, 3), generator=gb, device=device) * 0.4 - 0.2
        targets = transform_points(euler_angles_to_matrix(rpys, "XYZ"), tb,
                                   ref.expand(B, *ref.shape))
        t0 = time.perf_counter()
        outs = searcher.search_batch(
            torch.Generator(device=device).manual_seed(args.seed + 2),
            targets)
        synchronize(outs["score"])
        dt = time.perf_counter() - t0
        scores = outs["score"].cpu().numpy()
        print(f"batched search over {B} targets: {dt:.2f}s (first call),"
              f" chamfer mean {scores.mean():.5f} max {scores.max():.5f}")
        res["batch_scores"] = scores
    return res


if __name__ == "__main__":
    main()

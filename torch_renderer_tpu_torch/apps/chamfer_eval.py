"""Chamfer loss-landscape evaluation (is chamfer a good pose metric?), in
the PyTorch port, with the CLI and printout of the JAX package's
apps/chamfer_eval.py (the reference's chamfer_loss_evaluation.py:77-201).

Random poses about the ground truth (the identity) are scored with one
batched chamfer call each chunk; the app prints the correlation of chamfer
with the translation and rotation errors and, with --plot, scatters them
(needs matplotlib).

  python -m torch_renderer_tpu_torch.apps.chamfer_eval
  python -m torch_renderer_tpu_torch.apps.chamfer_eval --device cpu --poses 200 --points 128

The default --device cuda raises when no CUDA device is present (there is
no fallback); pass --device cpu to run on the CPU.
"""

from __future__ import annotations

import numpy as np

from ._common import base_parser, load_scene_mesh, resolve_app_device


def parse_args(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--poses", type=int, default=1000)
    p.add_argument("--points", type=int, default=500)
    p.add_argument("--trans-std", type=float, default=0.1)
    p.add_argument("--rot-std", type=float, default=0.5)
    p.add_argument("--plot", type=str, default=None, help="output PNG path")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_app_device(args)

    import torch

    from ..ops.sample_points import sample_points_from_meshes
    from ..opt.pose_search import chamfer_loss_landscape

    meshes = load_scene_mesh(args)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    pts = sample_points_from_meshes(meshes, args.points, gen)[0]
    out = chamfer_loss_landscape(
        gen, pts, torch.eye(3, device=device), torch.zeros(3, device=device),
        n_poses=args.poses, translation_std=args.trans_std,
        rotation_std=args.rot_std)
    cham, terr, rerr = (out[k].cpu().numpy()
                        for k in ("chamfer", "trans_err", "rot_err"))
    corr_t = float(np.corrcoef(cham, terr)[0, 1])
    corr_r = float(np.corrcoef(cham, rerr)[0, 1])
    print(f"{args.poses} poses: chamfer [{cham.min():.5f}, {cham.max():.5f}]")
    print(f"corr(chamfer, trans_err) = {corr_t:.3f}")
    print(f"corr(chamfer, rot_err)   = {corr_r:.3f}")

    if args.plot:
        from ..utils.plotting import _pyplot

        plt = _pyplot()
        plt.switch_backend("Agg")
        fig, (a1, a2) = plt.subplots(1, 2, figsize=(10, 4))
        a1.scatter(terr, cham, s=3, alpha=0.4)
        a1.set_xlabel("translation error (m)")
        a1.set_ylabel("chamfer")
        a2.scatter(np.degrees(rerr), cham, s=3, alpha=0.4)
        a2.set_xlabel("rotation error (deg)")
        fig.tight_layout()
        fig.savefig(args.plot, dpi=120)
        plt.close(fig)
        print("saved", args.plot)
    return {"chamfer": cham, "trans_err": terr, "rot_err": rerr,
            "corr_trans": corr_t, "corr_rot": corr_r}


if __name__ == "__main__":
    main()

"""Object pose fit against recorded depth frames, in the PyTorch port, with
the CLI and printout of the JAX package's apps/object_pose_from_depth.py
(the reference's pose_optimizer.py).

Load recorded sensor frames (filtered_datas.pkl format: intrinsic /
extrinsic / object_pose / rendered_depth), build depth + silhouette
references from the recorded depth (:41-61), perturb the pose's
translation by perturb_t * N(0, 1) from the seed and fit it with Adam
(:119-150; the reference's loop lacks optimizer.step(), this one steps):
the camera of one frame (DepthPoseFitter), or with --object-pose one
object 4x4 pose seen through the frames' fixed extrinsics
(ObjectPoseFitter). On the card each iteration is a replay of a captured
CUDA graph (the fitters' default). Without --pickle it first renders a
recording of the scene mesh at look_at(2.6, 25, 35), 160x160, into a
temporary file.

  python -m torch_renderer_tpu_torch.apps.object_pose_from_depth
  python -m torch_renderer_tpu_torch.apps.object_pose_from_depth --device cpu --object-pose --iters 40

The default --device cuda raises when no CUDA device is present (there is
no fallback); pass --device cpu to run on the CPU.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np

from ._common import (
    base_parser,
    load_scene_mesh,
    pinhole_K,
    resolve_app_device,
)


def parse_args(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--pickle", type=str, default=None)
    p.add_argument("--frame", type=int, default=0,
                   help="recorded frame index")
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--perturb-t", type=float, default=0.08)
    p.add_argument("--object-pose", action="store_true",
                   help="optimize ONE object 4x4 pose through the recorded "
                        "fixed per-frame extrinsics (the reference's "
                        "cam_ext @ object_mat chain, pose_optimizer.py:88-91) "
                        "jointly over --frames")
    p.add_argument("--frames", type=int, nargs="*", default=None,
                   help="frame indices for --object-pose (default: just "
                        "--frame). Pass several ONLY when the recorded "
                        "frames observe the SAME object pose")
    return p.parse_args(argv)


def _demo_recording(meshes, device, path):
    """A one-frame recording of the scene mesh, rendered by the port."""
    from ..cameras.look_at import look_at_view_transform
    from ..io.fixtures import save_recorded_frames
    from ..renderer import DepthRender

    H = W = 160
    K = pinhole_K((H, W))
    R, t = look_at_view_transform(2.6, 25.0, 35.0)
    depth = DepthRender(K, (H, W), device=device).render(
        meshes, R.to(device), t.to(device))[0].cpu().numpy()
    ext = np.eye(4, dtype=np.float32)
    ext[:3, :3] = R[0].numpy()
    ext[:3, 3] = t[0].numpy()
    save_recorded_frames(path, [{
        "object_id": 0, "object_pose": np.eye(4, dtype=np.float32),
        "extrinsic": ext, "intrinsic": K, "rendered_depth": depth,
    }])
    print(f"(demo mode: synthesized recording at {path})")


def _fit(fitter, meshes, refs, params0, iters):
    """fitter.fit timed by the host clock (the first iteration's set-up
    and, on the card, the capture included)."""
    from ..utils.timing import synchronize

    t_start = time.perf_counter()
    params, hist = fitter.fit(meshes, refs, params0, n_steps=iters)
    synchronize(params)
    return params, hist, time.perf_counter() - t_start


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_app_device(args)

    from ..io.fixtures import load_recorded_frames
    from ..opt.pose_fit import (
        DepthPoseFitter,
        ObjectPoseFitter,
        PoseFitConfig,
        pose_params_from_Rt,
        pose_params_to_Rt,
    )

    meshes = load_scene_mesh(args)
    with tempfile.TemporaryDirectory() as tmp:
        path = args.pickle
        if path is None:
            path = os.path.join(tmp, "object_pose_recording.pkl")
            _demo_recording(meshes, device, path)
        rec = load_recorded_frames(path)
    i = args.frame
    H, W = rec["depth"].shape[1:]
    cfg = PoseFitConfig(lr=args.lr, use_rgb=False)
    rng = np.random.default_rng(args.seed)

    if args.object_pose:
        # default: one frame; recorded datasets may store a DIFFERENT
        # object pose per frame of the same object, and a joint fit needs
        # frames that observe one static pose
        frames = args.frames if args.frames else [i]
        F = len(frames)
        fitter = ObjectPoseFitter(rec["K"][frames], (H, W),
                                  rec["extrinsic"][frames], cfg,
                                  device=device)
        refs = fitter.references_from_recorded(rec["depth"][frames], device)
        obj_gt = rec["object_pose"][i]
        obj0 = obj_gt.copy()
        perturb = args.perturb_t * rng.standard_normal(3).astype(np.float32)
        obj0[:3, 3] += perturb
        params0 = ObjectPoseFitter.params_from_object_pose(obj0, device)
        params, hist, elapsed = _fit(fitter, meshes.extend(F), refs, params0,
                                     args.iters)
        losses = hist["loss"].cpu().numpy()
        M = fitter.object_pose(params).cpu().numpy()
        err0 = float(np.linalg.norm(perturb))
        err1 = float(np.linalg.norm(M[:3, 3] - obj_gt[:3, 3]))
        print(f"object-pose fit over {F} frame(s) {frames}: "
              f"loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
              f"object translation err {err0:.4f} -> {err1:.4f} m; "
              f"{args.iters / elapsed:.1f} iters/sec (incl. compile)")
        return {"losses": losses, "err": (err0, err1),
                "it_s": args.iters / elapsed}

    fitter = DepthPoseFitter(rec["K"][i], (H, W), cfg, device=device)
    refs = fitter.references_from_recorded(rec["depth"][i], device)
    t0_ = rec["t"][i] + args.perturb_t * rng.standard_normal(3).astype(
        np.float32)
    params0 = pose_params_from_Rt(rec["R"][i], t0_, device)
    params, hist, elapsed = _fit(fitter, meshes, refs, params0, args.iters)
    losses = hist["loss"].cpu().numpy()
    _, t_fit = pose_params_to_Rt(params)
    err0 = float(np.linalg.norm(t0_ - rec["t"][i]))
    err1 = float(np.linalg.norm(t_fit[0].cpu().numpy() - rec["t"][i]))
    print(f"loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
          f"translation err {err0:.4f} -> {err1:.4f} m; "
          f"{args.iters / elapsed:.1f} iters/sec (incl. compile)")
    return {"losses": losses, "err": (err0, err1),
            "it_s": args.iters / elapsed}


if __name__ == "__main__":
    main()

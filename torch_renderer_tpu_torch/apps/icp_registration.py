"""Batched ICP registration benchmark: accuracy and a device-against-CPU
timing sweep, in the PyTorch port, with the CLI and printout of the JAX
package's apps/icp_registration.py (the reference's
pytorch3d_icp_registeration.py).

N synthetic pairs with known SE(3) perturbations, crop and noise
(reference :77-152) are registered by one batched ICP (ICP_on_GPU,
:154-185; on the card each ICP step is a replay of a captured CUDA graph)
and scored by translation and rotation error (:299-330); --sweep times
object counts 1-100 against the numpy CPU solver (ICP_on_CPU :191-238,
time_running_statistic :240-257). The source cloud is sampled from the
scene mesh (--obj, or the normalized level-3 icosphere).

  python -m torch_renderer_tpu_torch.apps.icp_registration
  python -m torch_renderer_tpu_torch.apps.icp_registration --device cpu --objects 8 --points 200 --icp-iters 30

The default --device cuda raises when no CUDA device is present (there is
no fallback); pass --device cpu to run on the CPU. --mesh-shape (sharding
the objects over several cards) waits for ROADMAP Queue 1 item 24.
"""

from __future__ import annotations

import time

import numpy as np

from ._common import base_parser, load_scene_mesh, resolve_app_device


def parse_args(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--objects", type=int, default=300)
    p.add_argument("--points", type=int, default=500)
    p.add_argument("--icp-iters", type=int, default=100)
    p.add_argument("--crop", type=float, default=0.0)
    p.add_argument("--noise", type=float, default=0.0)
    p.add_argument("--sweep", action="store_true",
                   help="object-count scaling sweep (1..100) vs CPU reference")
    p.add_argument("--mesh-shape", type=str, default=None,
                   help="'d,m' device-mesh shape: shard the object axis "
                        "(not ported yet: ROADMAP Queue 1 item 24)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_app_device(args)
    if args.mesh_shape:
        raise NotImplementedError(
            "--mesh-shape needs the port's parallel/ (torch.distributed), "
            "ROADMAP Queue 1 item 24")

    import torch

    from ..ops.sample_points import sample_points_from_meshes
    from ..opt.registration import (
        RegisterDataConfig,
        create_register_data,
        evaluate_registration,
        icp_cpu_reference,
        register_batch,
    )
    from ..utils.timing import synchronize

    meshes = load_scene_mesh(args)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    base = sample_points_from_meshes(meshes, args.points, gen)[0]
    cfg = RegisterDataConfig(n_objects=args.objects, crop_fraction=args.crop,
                             noise_std=args.noise)
    data = create_register_data(gen, base, cfg)

    def timed(d):
        t0 = time.perf_counter()
        sol = register_batch(d, max_iterations=args.icp_iters)
        synchronize(sol.rmse)
        return sol, time.perf_counter() - t0

    sol, first = timed(data)
    sol, steady = timed(data)
    m = evaluate_registration(sol, data["gt_R"], data["gt_t"])
    n_conv = int(sol.converged.sum())
    print(f"batched ICP over {args.objects} x {args.points}-pt clouds: "
          f"{steady:.3f}s steady ({first:.2f}s the first call, set-up "
          "included)")
    print(f"mean translation err {float(m['mean_trans_err']):.5f} m, "
          f"mean rotation err {np.degrees(float(m['mean_rot_err'])):.3f} "
          f"deg, converged {n_conv}/{args.objects}")
    out = {"steady_s": steady, "first_s": first,
           "mean_trans_err": float(m["mean_trans_err"]),
           "mean_rot_err": float(m["mean_rot_err"]),
           "trans_err": m["trans_err"].cpu().numpy(),
           "rot_err": m["rot_err"].cpu().numpy(), "converged": n_conv,
           "sweep": []}

    if args.sweep:
        print("\nobject-count sweep (device batched vs numpy CPU serial):")
        for n in (1, 5, 10, 25, 50, 100):
            if n > args.objects:
                break
            sub = {k: v[:n] for k, v in data.items()}
            timed(sub)
            _, dev = timed(sub)
            src = sub["source"].cpu().numpy()
            tgt = sub["target"].cpu().numpy()
            t0 = time.perf_counter()
            for b in range(min(n, 5)):  # the CPU is slow: extrapolate from 5
                icp_cpu_reference(src[b], tgt[b],
                                  max_iterations=args.icp_iters)
            cpu = (time.perf_counter() - t0) / min(n, 5) * n
            print(f"  n={n:4d}: device {dev:.3f}s  cpu(est) {cpu:.3f}s  "
                  f"speedup {cpu / dev:.1f}x")
            out["sweep"].append({"n": n, "device_s": dev, "cpu_s": cpu})
    return out


if __name__ == "__main__":
    main()

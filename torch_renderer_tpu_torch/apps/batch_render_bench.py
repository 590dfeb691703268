"""Batched depth-render benchmark: the reference's metric harness, with the
CLI and printout of the JAX package's apps/batch_render_bench.py.

Renders N look-at depth images (azimuths evenly spaced over 360 degrees,
elevation 15, distance 2.7) of a level-3 icosphere normalized to the unit
sphere, in calls of --view-chunk views, and prints the auto-sized budgets,
the batched throughput, the serial single-view rate and depth statistics.
Budgets left at 0 are sized from all N views. Every call runs the K=1
hard-raster kernel once, the tile-gather kernel once and the untile kernel
once, for all four fragment fields.

  python -m torch_renderer_tpu_torch.apps.batch_render_bench
  python -m torch_renderer_tpu_torch.apps.batch_render_bench --device cpu --n-views 4 --view-chunk 2 --height 72 --width 128 --reps 1

The default --device cuda raises when no CUDA device is present (there is
no fallback). With several cards visible it renders on --device alone: the
JAX app's multi-chip view sharding is not ported. The port's kernels give
every active tile the full max_faces_per_bin, so the app sizes no occupancy
split (the JAX app's --no-occupancy-split is accepted and has no effect).
"""

from __future__ import annotations

import numpy as np
import torch

from ._common import base_parser, load_scene_mesh, pinhole_K


def parse_args(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--n-views", type=int, default=120)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--view-chunk", type=int, default=12,
                   help="views per device call (bounds the per-pixel buffers "
                        "at large image sizes)")
    p.add_argument("--bin-size", type=int, default=32)
    p.add_argument("--raster-impl", choices=["auto", "xla", "pallas"],
                   default="auto",
                   help="accepted for CLI parity; binned calls run the CUDA "
                        "kernels whatever it says")
    p.add_argument("--max-faces-per-bin", type=int, default=0,
                   help="0 = auto-size from the scene's measured max tile "
                        "occupancy (x1.3)")
    p.add_argument("--active-tiles", type=int, default=0,
                   help="active-tile compaction budget; 0 = auto-size from "
                        "the scene's non-empty tile count, -1 = disable "
                        "compaction")
    p.add_argument("--select-impl", choices=["auto", "affine"],
                   default="affine",
                   help="accepted for CLI parity; the port has one K=1 "
                        "selection kernel")
    p.add_argument("--no-occupancy-split", action="store_true",
                   help="accepted for CLI parity; the port sizes no "
                        "occupancy split (its kernels give every active "
                        "tile the full max_faces_per_bin)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the benchmark; returns its numbers and the number of render
    calls it made."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "available")

    from ..cameras.look_at import look_at_view_transform
    from ..cameras.perspective import PerspectiveCamera
    from ..rasterize.binning import (
        count_overflow,
        set_budget_check_default,
        suggest_active_tiles_fd,
    )
    from ..rasterize.geometry import setup_faces
    from ..renderer import DepthRender
    from ..utils.timing import StageTimer, time_fn

    set_budget_check_default(args.check_budgets)
    H, W = args.height, args.width
    N = args.n_views
    meshes = load_scene_mesh(args)
    K = pinhole_K((H, W))

    azims = np.linspace(0.0, 360.0, N, endpoint=False).astype(np.float32)
    Rs, ts = look_at_view_transform(2.7, 15.0, torch.from_numpy(azims))

    mfb = args.max_faces_per_bin
    act = args.active_tiles
    if mfb == 0 or act == 0:
        # size budgets from ALL views (a single chunk's azimuth range can
        # under-count an asymmetric scene's densest tiles; overflowing
        # bins silently drop faces)
        cam0 = PerspectiveCamera.from_K(K, (H, W), R=Rs, t=ts, device=device)
        with torch.no_grad():
            fd0 = setup_faces(meshes.extend(N), cam0)
        if mfb == 0:
            max_count, _ = count_overflow(fd0, (H, W), args.bin_size, 0, 0.0)
            mfb = max(8, int(float(max_count) * 1.3))
            print(f"auto max_faces_per_bin = {mfb} "
                  f"(measured max {int(max_count)})")
        if act == 0:
            act = suggest_active_tiles_fd(fd0, (H, W), args.bin_size, 0.0)
            print(f"auto active_tiles = {act}")
        del fd0, cam0

    renderer = DepthRender(
        K, (H, W), pixel_chunk=1048576,
        bin_size=args.bin_size, max_faces_per_bin=mfb,
        impl=args.raster_impl,
        active_tiles=None if act < 0 else act,
        select_impl=args.select_impl,
        device=device,
    )
    vc = min(args.view_chunk, N)
    batched = meshes.extend(vc)

    timer = StageTimer()
    chunks = []
    with timer.stage("h2d+setup", sync=chunks):
        Rs = Rs.to(device)
        ts = ts.to(device)
        for v0 in range(0, N, vc):
            idx = torch.tensor([min(v0 + i, N - 1) for i in range(vc)],
                               device=device)
            chunks.append((Rs[idx], ts[idx]))

    n_cards = torch.cuda.device_count() if device.type == "cuda" else 1
    if n_cards > 1:
        print(f"NOT sharding: {n_cards} cards visible; the port renders on "
              f"{device} only")

    calls = [0]

    @torch.no_grad()
    def render(m, R, t):
        calls[0] += 1
        return renderer.render(m, R, t)

    def render_all():
        return [render(batched, R, t) for R, t in chunks]

    res = time_fn(render_all, reps=args.reps,
                  name=f"batched depth render {N}x{H}x{W} (chunks of {vc})")
    print(res)
    fps = N / res.mean_s
    print(f"throughput: {fps:.1f} depth images/sec (batched)")

    # serial single-view loop for comparison (the pyrender-style pattern)
    r1 = time_fn(render, meshes, Rs[:1], ts[:1], reps=min(args.reps, 5),
                 name="serial single-view render")
    print(r1)
    print(f"serial-equivalent: {1.0 / r1.mean_s:.1f} images/sec "
          f"-> batching speedup {fps * r1.mean_s:.1f}x")

    depth = render(batched, Rs[:vc], ts[:vc]).cpu().numpy()
    print("depth stats: shape", depth.shape, "coverage",
          float((depth > 0).mean()), "max", float(depth.max()))
    print(f"stages: {timer.report()}")
    return {"max_faces_per_bin": mfb, "active_tiles": act,
            "images_per_s": fps, "serial_images_per_s": 1.0 / r1.mean_s,
            "calls": calls[0], "coverage": float((depth > 0).mean()),
            "depth_max": float(depth.max())}


if __name__ == "__main__":
    main()

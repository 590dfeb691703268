"""Batched depth-render benchmark: the reference's metric harness, with the
CLI and printout of the JAX package's apps/batch_render_bench.py.

Renders N look-at depth images (azimuths evenly spaced over 360 degrees,
elevation 15, distance 2.7) of a level-3 icosphere normalized to the unit
sphere, in calls of --view-chunk views, and prints the auto-sized budgets,
the batched throughput, the serial single-view rate and depth statistics.
Budgets left at 0 are sized from all N views. Every call runs the K=1
hard-raster kernel once, the tile-gather kernel once and the untile kernel
once, for all four fragment fields.

On the card each call is a replay of a captured CUDA graph
(utils/graph.CapturedCall: one graph for the chunk of --view-chunk views,
one for the single view, each warmed up and captured by its first call,
as a jitted function compiles in its first; each call copies its R and t
into the graph's static inputs), the counterpart of the JAX app's jax.jit
of the render;
--eager runs each call op by op. Either way each chunk's depth is copied
into one preallocated (chunks x views, H, W) result inside the timed
region, as the JAX app's list keeps every chunk's array (a replay
overwrites its output).

  python -m torch_renderer_tpu_torch.apps.batch_render_bench
  python -m torch_renderer_tpu_torch.apps.batch_render_bench --device cpu --n-views 4 --view-chunk 2 --height 72 --width 128 --reps 1

With active tiles the app sizes the occupancy split as the JAX app does
(binning.suggest_occupancy_split_fd; --no-occupancy-split turns it off).

--spans turns the program's spans on (utils/timing.span) for the whole
run, so every graph is captured with its span markers: a profiler trace
of the run (torch.profiler, or utils/timing.profiler_trace) then names
each layer of every replay on the card's clock. A graph captured with
spans off shows none.

The default --device cuda raises when no CUDA device is present (there is
no fallback). With several cards (--cards N, default every visible card)
the app runs on N ranks (apps/_common.run_on_mesh: one card a rank under
NCCL, gloo where ranks share a card; under torchrun the group it gives)
and, as the JAX app does on several chips, splits each call's views over
them when --view-chunk divides by N (printing "NOT sharding" otherwise,
when every rank renders every view); each rank renders its views with no
collective and the throughput is the ranks' sum, also given per card.

  python -m torch_renderer_tpu_torch.apps.batch_render_bench --cards 4
"""

from __future__ import annotations

import numpy as np
import torch

from ._common import (
    add_eager_option,
    app_capture,
    base_parser,
    describe_mesh,
    load_scene_mesh,
    pinhole_K,
    resolve_app_device,
    run_on_mesh,
)


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
                   help="disable the two-budget occupancy split (auto-sized "
                        "via suggest_occupancy_split_fd when active tiles "
                        "are compacted)")
    p.add_argument("--cards", type=int, default=None,
                   help="ranks, one card each (default: every visible "
                        "card; 1 on the CPU)")
    p.add_argument("--spans", action="store_true",
                   help="capture every graph with the program's spans on "
                        "(utils/timing.span), for a profiler trace")
    add_eager_option(p, "each render call")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the benchmark; returns its numbers, the number of render calls
    it made and of those run from the host ("traced": each eager call,
    each graph's warm-up and capture; a replay launches from its graph),
    rank 0's on several cards, and on one process its last pass's depth
    images ("views", on the device)."""
    import torch
    import torch.distributed as dist

    from ..parallel.launch import init_from_env

    args = parse_args(argv)
    device = resolve_app_device(args)
    if init_from_env() or dist.is_initialized():
        cards = dist.get_world_size()
    else:
        cards = args.cards or (torch.cuda.device_count()
                               if device.type == "cuda" else 1)
    if cards > 1:
        return run_on_mesh(run, args, (cards, 1))
    return run(args, None)


def run(args, device_mesh) -> dict:
    """The benchmark on this process (device_mesh None) or on one rank of a
    data mesh; with spans on for the run under --spans."""
    from ..utils import timing

    before = timing.enable_spans(args.spans or timing.spans_enabled())
    try:
        return _run(args, device_mesh)
    finally:
        timing.enable_spans(before)


def _run(args, device_mesh) -> dict:
    device = resolve_app_device(args)

    from ..cameras.look_at import look_at_view_transform
    from ..cameras.perspective import PerspectiveCamera
    from ..rasterize.binning import (
        count_overflow,
        suggest_active_tiles_fd,
        suggest_occupancy_split_fd,
    )
    from ..rasterize.geometry import setup_faces
    from ..renderer import DepthRender
    from ..utils.graph import CapturedCall
    from ..utils.timing import StageTimer, time_fn

    H, W = args.height, args.width
    N = args.n_views
    meshes = load_scene_mesh(args)
    K = pinhole_K((H, W))

    azims = np.linspace(0.0, 360.0, N, endpoint=False).astype(np.float32)
    Rs, ts = look_at_view_transform(2.7, 15.0, torch.from_numpy(azims))

    mfb = args.max_faces_per_bin
    act = args.active_tiles
    split = None
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
        if act > 0 and not args.no_occupancy_split:
            split = suggest_occupancy_split_fd(fd0, (H, W), args.bin_size,
                                               0.0, act, mfb)
            print(f"auto occupancy_split = {split}")
        del fd0, cam0

    renderer = DepthRender(
        K, (H, W), pixel_chunk=1048576,
        bin_size=args.bin_size, max_faces_per_bin=mfb,
        impl=args.raster_impl,
        active_tiles=None if act < 0 else act,
        occupancy_split=split if act > 0 else None,
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

    n_cards, index = 1, 0
    if device_mesh is not None:
        from ..parallel.mesh import DATA_AXIS, axis_index, axis_size

        n_cards = axis_size(device_mesh, DATA_AXIS)
        index = axis_index(device_mesh, DATA_AXIS)
        print(describe_mesh(device_mesh))
    shard = n_cards > 1 and vc % n_cards == 0
    if shard:
        # this rank's views of every call: its slice of the view axis
        vl = vc // n_cards
        batched = meshes.extend(vl)
        chunks = [(R[index * vl:(index + 1) * vl],
                   t[index * vl:(index + 1) * vl]) for R, t in chunks]
        print(f"view axis sharded over {n_cards} cards ({vl} views/card/"
              "call)")
    elif n_cards > 1:
        print(f"NOT sharding: view_chunk {vc} % {n_cards} cards != 0")

    calls = [0]
    capture = app_capture(args)

    def call_of(m):
        @torch.no_grad()
        def render_mesh(R, t):
            return renderer.render(m, R, t)

        return CapturedCall(render_mesh, device, capture)

    graphs = {"batched": call_of(batched), "single": call_of(meshes)}

    def render(kind, R, t):
        calls[0] += 1
        return graphs[kind](R, t)

    views = torch.empty((len(chunks) * batched.batch_size, H, W),
                        device=device)
    single_view = torch.empty((1, H, W), device=device)

    def render_all():
        vb = batched.batch_size
        for i, (R, t) in enumerate(chunks):
            views[i * vb:(i + 1) * vb].copy_(render("batched", R, t))
        return views

    def render_single(R, t):
        return single_view.copy_(render("single", R, t))

    res = time_fn(render_all, reps=args.reps,
                  name=f"batched depth render {N}x{H}x{W} (chunks of {vc})")
    print(res)
    fps = N / res.mean_s
    if shard:   # every rank rendered its share: the rates add up
        import torch.distributed as dist

        total = torch.tensor([fps / n_cards], dtype=torch.float64,
                             device=device)
        dist.all_reduce(total)
        fps = float(total)
    print(f"throughput: {fps:.1f} depth images/sec (batched)"
          + (f" = {fps / n_cards:.1f}/card over {n_cards} cards"
             if shard else ""))

    # serial single-view loop for comparison (the pyrender-style pattern)
    r1 = time_fn(render_single, Rs[:1], ts[:1], reps=min(args.reps, 5),
                 name="serial single-view render")
    print(r1)
    print(f"serial-equivalent: {1.0 / r1.mean_s:.1f} images/sec "
          f"-> batching speedup {fps * r1.mean_s:.1f}x")

    R0, t0 = chunks[0]
    depth = render("batched", R0, t0)
    # "warn" budget checks: each call recorded its counts on the device;
    # one read for the whole run
    for graph in graphs.values():
        graph.warn_budgets()
    if shard:
        from ..parallel.mesh import all_gather_batch

        depth = all_gather_batch(depth, device_mesh)
    depth = depth.cpu().numpy()
    print("depth stats: shape", depth.shape, "coverage",
          float((depth > 0).mean()), "max", float(depth.max()))
    print(f"stages: {timer.report()}")
    return {"max_faces_per_bin": mfb, "active_tiles": act,
            "occupancy_split": split if act > 0 else None,
            "images_per_s": fps, "serial_images_per_s": 1.0 / r1.mean_s,
            "calls": calls[0], "cards": n_cards, "sharded": shard,
            "traced": sum(g.bodies for g in graphs.values()),
            "coverage": float((depth > 0).mean()),
            "depth_max": float(depth.max()),
            "views": views if device_mesh is None else None}


if __name__ == "__main__":
    main()

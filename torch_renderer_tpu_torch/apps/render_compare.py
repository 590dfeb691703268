"""Renderer fidelity comparison on recorded sensor data, in the PyTorch
port, with the CLI and printout of the JAX package's apps/render_compare.py.

Load recorded frames (filtered_datas.pkl format: K / extrinsic /
object_pose / rendered_depth), render the same views with the port's
DepthRender AND an independent oracle renderer, and report per-frame depth
differences and per-stage timings: the reference's pixel-fidelity gate
(renderer_comparison_with_pyrender.py:254-259).

Oracle selection (--oracle):
  raytrace  (default) the float64 numpy ray caster (baselines.VisRaytrace),
            independent of the rasterizer's formulation;
  pyrender  the reference's own OpenGL oracle, used when installed (it
            falls back to raytrace when not);
  none      skip the cross-renderer diff (recorded-vs-ours only).

Without --pickle it first renders a recording of three views (look_at(2.5,
20, azimuth 0 / 60 / 140)) with the port, writes it to a temporary file
and reads it back (the fixture pathway end to end), then runs the
cross-renderer diff against the oracle.

  python -m torch_renderer_tpu_torch.apps.render_compare
  python -m torch_renderer_tpu_torch.apps.render_compare --device cpu --image-size 48

The default --device cuda raises when no CUDA device is present (there is
no fallback); pass --device cpu to run on the CPU.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from ._common import (
    base_parser,
    load_scene_mesh,
    pinhole_K,
    resolve_app_device,
)


def _diff_report(name, ours, other, interior_only=True):
    """Per-frame coverage IoU + depth diff stats. Edge pixels legitimately
    differ by sub-pixel sampling between renderers, so depth stats are taken
    on interior pixels (3x3-stable coverage) when interior_only."""
    N = ours.shape[0]
    worst = 0.0
    for i in range(N):
        cov_a, cov_b = ours[i] > 0, other[i] > 0
        both = cov_a & cov_b
        union = cov_a | cov_b
        iou = both.sum() / max(union.sum(), 1)
        sel = both
        if interior_only:
            sel = both.copy()
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    sel &= np.roll(both, (dy, dx), axis=(0, 1))
            sel[0, :] = sel[-1, :] = False
            sel[:, 0] = sel[:, -1] = False
        d = np.abs(ours[i] - other[i])[sel]
        mean_d = d.mean() if d.size else 0.0
        max_d = d.max() if d.size else 0.0
        worst = max(worst, max_d)
        print(f"[{name}] frame {i}: coverage IoU {iou:.4f}, "
              f"interior depth |diff| mean {mean_d:.5f} max {max_d:.5f}")
    return worst


def parse_args(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--pickle", type=str, default=None,
                   help="recorded frames pickle (filtered_datas.pkl format)")
    p.add_argument("--image-size", type=int, default=180)
    p.add_argument("--oracle", choices=("raytrace", "pyrender", "none"),
                   default="raytrace")
    p.add_argument("--plot", type=str, default=None, help="diff image PNG")
    return p.parse_args(argv)


def _self_recording(meshes, size, device, path):
    """Render three views with the port and write them as a recording."""
    from ..cameras.look_at import look_at_view_transform
    from ..io.fixtures import save_recorded_frames
    from ..renderer import DepthRender

    K = pinhole_K(size)
    R, t = look_at_view_transform(2.5, 20.0, [0.0, 60.0, 140.0])
    depth = DepthRender(K, size, device=device).render(
        meshes.extend(3), R.to(device), t.to(device)).cpu().numpy()
    frames = []
    for i in range(3):
        ext = np.eye(4, dtype=np.float32)
        ext[:3, :3] = R[i].numpy()
        ext[:3, 3] = t[i].numpy()
        frames.append({
            "object_id": i, "object_pose": np.eye(4, dtype=np.float32),
            "extrinsic": ext, "intrinsic": K, "rendered_depth": depth[i],
        })
    save_recorded_frames(path, frames)
    print(f"(self-check mode: wrote {path})")


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_app_device(args)

    from ..io.fixtures import load_recorded_frames
    from ..renderer import DepthRender
    from ..utils.timing import StageTimer, synchronize

    meshes = load_scene_mesh(args)
    with tempfile.TemporaryDirectory() as tmp:
        path = args.pickle
        if path is None:
            path = os.path.join(tmp, "recorded_selfcheck.pkl")
            _self_recording(meshes, (args.image_size, args.image_size),
                            device, path)
        rec = load_recorded_frames(path)
    N, H, W = rec["depth"].shape
    print(f"{N} recorded frames @ {H}x{W}")

    timer = StageTimer()
    with timer.stage("camera+renderer construction"):
        dr = DepthRender(rec["K"], (H, W), device=device)
    with timer.stage("batched depth render (ours)"):
        ours = dr.render(meshes.extend(N), rec["R"], rec["t"])
        synchronize(ours)
    ours = ours.cpu().numpy()

    # the cross-renderer oracle, one frame a call (the reference compares
    # against pyrender serially, one frame per OpenGL call)
    from .. import baselines

    oracle = None
    if args.oracle == "pyrender":
        if not baselines.pyrender_available():
            print("pyrender not installed; falling back to --oracle raytrace")
            args.oracle = "raytrace"
        else:
            vis = baselines.VisPyrender((H, W))
    if args.oracle == "raytrace":
        vis = baselines.VisRaytrace((H, W))
    if args.oracle != "none":
        verts, faces = meshes.verts_list()[0], meshes.faces_list()[0]
        Ks = np.asarray(rec["K"])
        if Ks.ndim == 2:
            Ks = np.broadcast_to(Ks, (N, 3, 3))
        with timer.stage(f"serial oracle renders ({args.oracle})"):
            oracle = np.stack([
                vis.quick_depth_render(verts, faces, Ks[i], np.concatenate([
                    np.concatenate([np.asarray(rec["R"][i], np.float64),
                                    np.asarray(rec["t"][i],
                                               np.float64)[:, None]], 1),
                    [[0.0, 0.0, 0.0, 1.0]]], 0))
                for i in range(N)])
    print(timer.report())

    recd = rec["depth"]
    _diff_report("ours vs recorded", ours, recd,
                 interior_only=args.pickle is not None)
    worst = None
    if oracle is not None:
        worst = _diff_report(f"ours vs {args.oracle}", ours, oracle)
        print(f"cross-renderer gate: worst interior |diff| {worst:.5f}")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        rows = [("recorded", recd), ("ours", ours)]
        if oracle is not None:
            rows.append((args.oracle, oracle))
        rows.append(("|ours-ref|", np.abs(
            ours - (oracle if oracle is not None else recd))))
        n = min(N, 4)
        fig, axes = plt.subplots(len(rows), n, figsize=(4 * n, 3 * len(rows)),
                                 squeeze=False)
        for i in range(n):
            for r, (title, img) in enumerate(rows):
                axes[r][i].imshow(img[i])
                axes[r][i].set_title(title)
                axes[r][i].axis("off")
        fig.tight_layout()
        fig.savefig(args.plot, dpi=110)
        print("saved", args.plot)
    return {"ours": ours, "oracle": oracle, "recorded": recd,
            "worst": worst, "stages": dict(timer.stages)}


if __name__ == "__main__":
    main()

"""Minimal renderer demo of the PyTorch port, with the CLI of the JAX
package's apps/quick_render.py: a turntable of the scene mesh (--obj, or a
level-3 icosphere normalized to the unit sphere) seen by look_at(2.7, 20,
azimuth) from --frames azimuths, rendered in one batched MeshRenderer call
(K=1, Phong RGB and depth); writes rgb_XXX.png and depth_XXX.png (depth
scaled by its largest value) with the port's standard-library PNG writer,
and turntable.gif with --gif when imageio is importable.

  python -m torch_renderer_tpu_torch.apps.quick_render
  python -m torch_renderer_tpu_torch.apps.quick_render --device cpu --image-size 64

The default --device cuda raises when no CUDA device is present (there is
no fallback); pass --device cpu to run on the CPU.
"""

from __future__ import annotations

import os

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
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--out-dir", type=str, default="render_out")
    p.add_argument("--gif", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_app_device(args)

    from ..cameras.look_at import look_at_view_transform
    from ..io.png import write_png
    from ..renderer import MeshRenderer

    H = W = args.image_size
    meshes = load_scene_mesh(args)
    renderer = MeshRenderer(pinhole_K((H, W)), (H, W), faces_per_pixel=1,
                            device=device)
    azims = np.linspace(-180.0, 180.0, args.frames, endpoint=False,
                        dtype=np.float32)
    Rs, ts = look_at_view_transform(2.7, 20.0, azims)
    out = renderer.render(meshes.extend(args.frames), Rs.to(device),
                          ts.to(device), with_silhouette=True, with_rgb=True)

    os.makedirs(args.out_dir, exist_ok=True)
    rgb = out.rgb.cpu().numpy()
    depth = out.depth.cpu().numpy()
    frames = []
    for i in range(args.frames):
        img = (np.clip(rgb[i], 0, 1) * 255).astype(np.uint8)
        write_png(os.path.join(args.out_dir, f"rgb_{i:03d}.png"), img)
        d = depth[i]
        dn = (d / d.max() * 255).astype(np.uint8) if d.max() > 0 \
            else d.astype(np.uint8)
        write_png(os.path.join(args.out_dir, f"depth_{i:03d}.png"), dn)
        frames.append(img)
    coverage = float((depth > 0).mean())
    print(f"wrote {args.frames} rgb+depth frames to {args.out_dir}/ "
          f"(coverage {coverage:.3f})")

    if args.gif:
        try:
            import imageio

            imageio.mimsave(os.path.join(args.out_dir, "turntable.gif"),
                            frames, fps=8)
            print("wrote turntable.gif")
        except ImportError:
            print("imageio not installed; skipped GIF")
    return {"coverage": coverage, "depth_max": float(depth.max()),
            "rgb": rgb, "depth": depth}


if __name__ == "__main__":
    main()

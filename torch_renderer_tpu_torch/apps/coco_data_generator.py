"""Synthetic COCO dataset generation (domain-randomized scenes), in the
PyTorch port, with the flags of the JAX package's
apps/coco_data_generator.py (the reference's coco_data_generator.py).

Renders multi-object scenes with the port's renderer and writes images/,
aux/ (depth, instance seg and normals), annotations.json (COCO, with
optional contiguous category remapping) and poses.json (6-DoF labels),
with optional Canny edge maps.

  python -m torch_renderer_tpu_torch.apps.coco_data_generator
  python -m torch_renderer_tpu_torch.apps.coco_data_generator --device cpu --scenes 1 --views-per-scene 2 --height 48 --width 64

The defaults are the reference's: 4 scenes of 25 views at 480x640, 2-5
objects a scene, random materials, rest placement. The default --device
cuda raises when no CUDA device is present (there is no fallback); pass
--device cpu to run on the CPU. --mesh-shape d,m runs the app on d * m
ranks (apps/_common.run_on_mesh: one card a rank under NCCL, or gloo)
with each chunk's views split over the 'data' axis; rank 0 writes the
dataset, which equals the unsplit run's. On the card each chunk render
and visibility count is a replay of a captured CUDA graph; --eager runs
them op by op (the same outputs).

  python -m torch_renderer_tpu_torch.apps.coco_data_generator --mesh-shape 2,1 --scenes 2
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from ._common import (
    add_eager_option,
    app_capture,
    base_parser,
    describe_mesh,
    parse_mesh_shape,
    resolve_app_device,
    run_on_mesh,
)


def parse_args(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--out-dir", type=str, default="coco_out")
    p.add_argument("--scenes", type=int, default=4)
    p.add_argument("--views-per-scene", type=int, default=25)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--min-objects", type=int, default=2)
    p.add_argument("--max-objects", type=int, default=5)
    p.add_argument("--material-mode",
                   choices=["vertex", "uniform", "texture", "random"],
                   default="random")
    p.add_argument("--placement", choices=["rest", "physics"],
                   default="rest",
                   help="'physics' drops objects and adopts the settled "
                        "rigid-body poses (the reference's Blender physics "
                        "step); 'rest' is the fast bbox-on-plane pose")
    p.add_argument("--edge-maps", action="store_true")
    p.add_argument("--room", action="store_true",
                   help="enclose every scene in a floor+4-wall room with a "
                        "per-scene randomized material")
    p.add_argument("--min-visible-px", type=int, default=0,
                   help="visibility-checked cameras: re-sample views until "
                        ">=1 instance has this many visible pixels, and "
                        "keep only annotations with >= this many")
    p.add_argument("--no-normals", action="store_true",
                   help="skip the normals pass")
    p.add_argument("--no-pack", action="store_true",
                   help="keep float32 outputs instead of the compact "
                        "u8/u16/i8 packing on the device")
    p.add_argument("--mesh-shape", type=str, default=None,
                   help="'d,m' device-mesh shape: shard each chunk's views "
                        "over the 'data' axis of d*m ranks")
    p.add_argument("--reformat", action="store_true",
                   help="remap category ids to contiguous 1..N (detectron2)")
    p.add_argument("--objs", type=str, nargs="*", default=None,
                   help="OBJ model paths for the object library "
                        "(default: built-in primitives)")
    p.add_argument("--instances", type=str, default=None,
                   help="model directory in the reference's instances.json "
                        "layout; overrides --objs")
    p.add_argument("--load-textures", action="store_true",
                   help="ingest the OBJs' own MTL/UV textures")
    p.add_argument("--texture-dir", type=str, default=None,
                   help="directory of texture image files for textured "
                        "scenes' object and room materials")
    p.add_argument("--distractor-objs", type=str, nargs="*", default=None,
                   help="OBJ paths rendered as occluding, non-annotated "
                        "distractors")
    p.add_argument("--distractors", type=str, default=None,
                   help="min,max distractors per scene (default 0,0; with "
                        "--distractor-objs and no explicit value: "
                        "1,len(library))")
    add_eager_option(p, "each chunk's render")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the app; returns its numbers: images, annotations, seconds,
    images/s, s a scene, and the COCO dict (rank 0's with --mesh-shape)."""
    args = parse_args(argv)
    resolve_app_device(args)
    if args.mesh_shape:
        return run_on_mesh(run, args, parse_mesh_shape(args.mesh_shape))
    return run(args, None)


def run(args, device_mesh) -> dict:
    """The app on this process (device_mesh None) or on one rank of a
    mesh; with a mesh, rank 0 alone writes."""
    device = resolve_app_device(args)

    import torch

    from ..datagen.coco import (
        COCODataGenerator,
        DataGenConfig,
        ObjectLibrary,
        reformat_coco_annotations,
    )

    if args.instances:
        library = ObjectLibrary.from_instances_json(
            args.instances, load_textures=args.load_textures)
    elif args.objs:
        library = ObjectLibrary.from_obj_files(
            args.objs, load_textures=args.load_textures)
    else:
        library = ObjectLibrary.primitives()
    distractor_library = None
    if args.distractor_objs:
        distractor_library = ObjectLibrary.from_obj_files(
            args.distractor_objs, load_textures=args.load_textures)
    if args.distractors is None:
        # the default only when the flag was not given: an explicit
        # "--distractors 0,0" with --distractor-objs places none
        if args.distractor_objs:
            d_lo, d_hi = 1, max(1, len(distractor_library.entries))
            print(f"--distractors not given: defaulting to {d_lo},{d_hi}")
        else:
            d_lo, d_hi = 0, 0
    else:
        d_lo, d_hi = (int(x) for x in args.distractors.split(","))

    cfg = DataGenConfig(
        image_size=(args.height, args.width),
        views_per_scene=args.views_per_scene,
        objects_per_scene=(args.min_objects, args.max_objects),
        distractors_per_scene=(d_lo, d_hi),
        material_mode=args.material_mode,
        texture_dir=args.texture_dir,
        placement_mode=args.placement,
        edge_maps=args.edge_maps,
        normal_maps=not args.no_normals,
        pack_outputs=not args.no_pack,
        room=args.room,
        min_visible_px=args.min_visible_px,
    )
    if device_mesh is not None:
        print(describe_mesh(device_mesh))
    gen = COCODataGenerator(library, cfg, device_mesh=device_mesh,
                            distractor_library=distractor_library,
                            device=device,
                            capture=app_capture(args))

    t0 = time.perf_counter()
    coco = gen.generate(args.out_dir, args.scenes,
                        rng=np.random.default_rng(args.seed))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    n_imgs = len(coco["images"])
    print(f"rendered {n_imgs} rgbd images ({args.scenes} scenes) in "
          f"{elapsed:.1f}s = {elapsed / max(args.scenes, 1):.2f}s/scene, "
          f"{len(coco['annotations'])} annotations")

    if args.reformat and gen._writer:
        out = reformat_coco_annotations(coco)
        path = os.path.join(args.out_dir, "annotations_contiguous.json")
        with open(path, "w") as f:
            json.dump(out, f)
        print("saved", path)
    return {"images": n_imgs, "annotations": len(coco["annotations"]),
            "seconds": elapsed, "images_per_s": n_imgs / elapsed,
            "s_per_scene": elapsed / max(args.scenes, 1),
            "max_faces_per_bin": gen._mfb,
            "renders_traced": gen.renders_traced, "coco": coco}


if __name__ == "__main__":
    main()

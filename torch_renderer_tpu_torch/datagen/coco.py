"""Synthetic COCO-style dataset generator driven by the port's renderer
(PyTorch counterpart of ``torch_renderer_tpu.datagen.coco``).

The capability-parity rebuild of the reference's BlenderProc pipeline
(coco_data_generator.py): domain-randomized multi-object scenes -> RGB +
depth + normals + instance segmentation + COCO JSON annotations + 6-DoF
pose labels (+ optional Canny edge maps). The randomization axes are the
reference's: ground-plane rest poses with a random yaw (or settled rigid
bodies, datagen/physics.py) at rejection-sampled non-overlapping positions;
per-object vertex-color / uniform-color materials or per-object textures
packed into one scene atlas (datagen/texgen.py); look-at cameras on a
spherical shell with a random in-plane roll; a point light on a shell with
intensity jitter.

Every random draw comes from the caller's ``np.random.Generator`` in the
JAX package's order, so one seed gives the same scenes, cameras, lights,
materials and labels in both packages. The views of a scene render in
chunks of ``view_chunk`` through one K=1 binned raster each (on the card:
the ``hard_k1`` kernel, the tile gather and the untile kernel), then hard
Phong shading, depth, camera-space normals and instance ids, packed on the
device to u8 rgb, u16 millimetre depth, i8 normals and u8 seg (255 =
background). Each chunk is copied into pinned host memory without waiting;
the host waits once a scene, after the last chunk. The chunk render runs
eagerly; annotations are decoded on the host from the packed seg.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..cameras.look_at import look_at_opencv
from ..renderer import MeshRenderer
from ..shading.gbuffer import instance_masks, instance_segmentation, render_normals
from ..shading.lights import PointLights
from ..structures.scenes import (
    SceneMeshes,
    merge_meshes,
    place_on_plane,
    room_planes,
    sample_nonoverlapping_xy,
)
from ..transforms.so3 import euler_angles_to_matrix
from .texgen import pack_atlas, planar_uvs, random_texture, resize_texture


@dataclasses.dataclass(frozen=True)
class DataGenConfig:
    image_size: Tuple[int, int] = (480, 640)
    views_per_scene: int = 25          # the reference renders 25 per scene
    objects_per_scene: Tuple[int, int] = (2, 5)
    # Distractor objects per scene (the reference mixes BOP distractors
    # into every scene): rendered and occluding in rgb/depth/normals/seg,
    # never annotated and absent from the categories table. Sampled from
    # library entries flagged {"distractor": True} and/or the
    # distractor_library passed to COCODataGenerator; (0, 0) disables.
    distractors_per_scene: Tuple[int, int] = (0, 0)
    placement_extent: float = 0.35
    object_scale: float = 0.12
    # "rest": bbox bottom on the plane with a random yaw. "physics": drop
    # the objects with random orientations and adopt the settled rigid-body
    # poses (datagen.physics; the reference's Blender physics step).
    placement_mode: str = "rest"
    camera_dist: Tuple[float, float] = (0.9, 1.6)
    camera_elev: Tuple[float, float] = (15.0, 70.0)
    max_inplane_deg: float = 25.0
    material_mode: str = "random"      # vertex | uniform | texture | random
    texture_size: int = 128            # per-object tile size in texture mode
    # Directory of texture image files (the reference's random texture
    # folder): textured scenes draw object and room tiles from these images
    # (resized to texture_size) in place of procedural patterns. Objects
    # carrying their own texture (ObjectLibrary load_textures=True) keep it.
    texture_dir: Optional[str] = None
    min_visibility: float = 0.002      # drop annotations below this coverage
    # Room geometry (the reference's floor + 4 walls) with a per-scene
    # randomized albedo (or an atlas tile in textured scenes), merged into
    # every scene as a non-annotated background object. room_extent must
    # exceed camera_dist's max so the cameras stay inside.
    room: bool = False
    room_extent: float = 2.0
    room_height: float = 2.0
    # Visibility-checked camera sampling (the reference's BVH obstacle /
    # interest check): when min_visible_px > 0, candidate views are checked
    # with a quarter-size seg render and re-sampled (up to
    # cam_resample_rounds) until at least min_visible_objects instances
    # carry >= min_visible_px full-size-equivalent pixels; written
    # annotations also need mask.sum() >= min_visible_px at full size.
    min_visible_px: int = 0
    min_visible_objects: int = 1
    cam_resample_rounds: int = 8
    # Reject camera centers closer than this to any object centroid (the
    # reference's 0.3 m camera obstacle clearance), on the host before any
    # render; 0 disables.
    cam_clearance: float = 0.3
    edge_maps: bool = False
    focal_scale: float = 0.9
    view_chunk: int = 8                # views rendered per device call
    bin_size: int = 32                 # the rasterizer's tile
    max_faces_per_bin: int = 128       # a floor: grown per scene
    active_tiles: int = 0              # 0: every tile gets a slot
    normal_maps: bool = True           # render and write the normals pass
    # The JAX package's selection engine for its XLA path ("affine"):
    # accepted and without effect here (one K=1 kernel runs).
    select_impl: str = "affine"
    # Pack outputs to compact dtypes on the device before the host copy:
    # rgb u8, depth u16 millimeters, normals i8, seg u8 (255 = background).
    pack_outputs: bool = True


DEPTH_SCALE = 1000.0   # packed depth unit: millimeters (u16, 0 = background)
SEG_BACKGROUND = 255   # packed background sentinel (u8); float path uses -1


def unpack_depth(depth_u16: np.ndarray) -> np.ndarray:
    """u16 millimeter depth -> f32 meters (0 stays 0 = background)."""
    return np.asarray(depth_u16, np.float32) / DEPTH_SCALE


def unpack_normals(normals_i8: np.ndarray) -> np.ndarray:
    """i8 packed normals -> f32 in [-1, 1]."""
    return np.asarray(normals_i8, np.float32) / 127.0


class ObjectLibrary:
    """The generator's model set (the reference loads target objects from
    instances.json + BOP distractors). Each entry: canonical verts
    (unit-ish scale), faces, category_id, name."""

    def __init__(self, entries: Sequence[Dict]):
        self.entries = list(entries)
        self.dataset_name: Optional[str] = None

    @staticmethod
    def primitives(n_categories: int = 3, level: int = 2) -> "ObjectLibrary":
        """Built-in primitive library (sphere / ellipsoid / box) for use
        without external assets."""
        from ..ops.icosphere import cube, icosphere

        sv, sf = icosphere(level)
        cv, cf = cube(1.4)
        entries = [
            {"verts": sv, "faces": sf, "category_id": 1, "name": "sphere"},
            {"verts": sv * np.array([1.0, 0.6, 0.4], np.float32),
             "faces": sf, "category_id": 2, "name": "ellipsoid"},
            {"verts": cv, "faces": cf, "category_id": 3, "name": "box"},
        ]
        return ObjectLibrary(entries[:max(1, n_categories)])

    @staticmethod
    def from_obj_files(
        paths: Sequence[str],
        category_map: Optional[Dict[str, Dict]] = None,
        normalize: bool = True,
        mm2m: bool = False,
        load_textures: bool = False,
    ) -> "ObjectLibrary":
        """Library from OBJ model files.

        category_map: {name: {"id": int, ...extra metadata}} keyed by the
        OBJ basename stem; unlisted names get enumerated ids after the
        mapped ones, and extra keys (supercategory, ...) go into the entry
        and the written COCO categories table. normalize: center and scale
        to unit max radius; mm2m: divide raw coordinates by 1000 first.
        load_textures: entries whose OBJ carries a texture map and vt
        coordinates get "texture" ((Hm, Wm, 3) f32) and per-vertex
        "verts_uvs" ((V', 2)): vertices are split at UV seams (unique
        (v, vt) pairs) so the UVs reuse the face table.
        """
        from ..io.obj import load_obj

        category_map = dict(category_map or {})
        used = {int(v["id"]) for v in category_map.values() if "id" in v}
        next_id = 1
        entries = []
        for path in paths:
            data = load_obj(path, load_textures=load_textures)
            v = np.asarray(data.verts, np.float32)
            faces = np.asarray(data.faces, np.int32)
            verts_uvs = None
            texture = None
            if (load_textures and data.texture_image is not None
                    and data.faces_uvs is not None):
                # split vertices at UV seams: unique (vertex, vt) pairs
                pairs = np.stack(
                    [faces.ravel(), np.asarray(data.faces_uvs,
                                               np.int32).ravel()], axis=1)
                uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
                faces = inv.reshape(-1, 3).astype(np.int32)
                v = v[uniq[:, 0]]
                verts_uvs = np.asarray(data.verts_uvs, np.float32)[uniq[:, 1]]
                texture = np.asarray(data.texture_image, np.float32)
            if mm2m:
                v = v / 1000.0
            if normalize:
                v = v - v.mean(0)
                v = v / max(float(np.linalg.norm(v, axis=1).max()), 1e-9)
            name = os.path.splitext(os.path.basename(path))[0]
            meta = dict(category_map.get(name, {}))
            if "id" in meta:
                cid = int(meta.pop("id"))
            else:
                while next_id in used:
                    next_id += 1
                cid = next_id
                used.add(cid)
            meta.pop("filename", None)
            entry = {
                "verts": v.astype(np.float32),
                "faces": faces,
                "category_id": cid,
                "name": meta.pop("name", name),
                **meta,
            }
            if texture is not None:
                entry["texture"] = texture
                entry["verts_uvs"] = verts_uvs
            entries.append(entry)
        return ObjectLibrary(entries)

    @staticmethod
    def from_instances_json(
        model_path: str, normalize: bool = True, mm2m: bool = False,
        load_textures: bool = False,
    ) -> "ObjectLibrary":
        """Library from a model directory in the reference's instances.json
        layout: {"dataset_name": ..., "categories": [{"id", "name",
        "filename", "supercategory"}, ...]} with per-category OBJ files
        relative to model_path."""
        json_fpath = os.path.join(model_path, "instances.json")
        if not os.path.isfile(json_fpath):
            raise FileNotFoundError(f"{json_fpath} not found")
        with open(json_fpath) as f:
            instances = json.load(f)
        paths, category_map = [], {}
        for cat in instances["categories"]:
            path = os.path.join(model_path, cat["filename"])
            if not os.path.exists(path):
                raise FileNotFoundError(f"object file not found: {path}")
            paths.append(path)
            stem = os.path.splitext(os.path.basename(path))[0]
            if stem in category_map:
                # categories are keyed by stem: two files sharing one would
                # merge their categories
                raise ValueError(
                    f"duplicate OBJ basename stem {stem!r} in instances.json "
                    "categories (e.g. a/x.obj and b/x.obj): stems must be "
                    "unique because category metadata is keyed by them")
            category_map[stem] = {
                k: v for k, v in cat.items() if k != "filename"}
        lib = ObjectLibrary.from_obj_files(
            paths, category_map, normalize=normalize, mm2m=mm2m,
            load_textures=load_textures)
        lib.dataset_name = instances.get("dataset_name")
        return lib

    def __len__(self):
        return len(self.entries)


def _bin_need(max_count: float) -> int:
    """A bin budget with 1.3x head-room over the measured occupancy, in
    steps of 64 (at least 64)."""
    return max(64, int(math.ceil(float(max_count) * 1.3 / 64.0)) * 64)


class COCODataGenerator:
    """Scene sampler + chunked renderer + COCO annotation writer, on
    ``device`` (default: the card; "cpu" runs the kernels' plain
    versions).

    device_mesh (parallel.make_mesh): each chunk's views are split over
    the mesh's 'data' ranks (every view is independent, so nothing is
    exchanged but the rendered chunk, one all_gather of its packed
    outputs); view_chunk is rounded up to a multiple of the axis size.
    Every rank samples the same scenes from the same rng and holds every
    image; rank 0 alone writes files. The outputs equal the single-card
    generator's."""

    def __init__(self, library: ObjectLibrary,
                 config: DataGenConfig = DataGenConfig(), device_mesh=None,
                 distractor_library: Optional[ObjectLibrary] = None,
                 device=None):
        self.library = library
        self.device_mesh = device_mesh
        self._writer = True
        if device_mesh is not None:
            import torch.distributed as dist

            from ..parallel.mesh import DATA_AXIS, axis_size, check_mesh

            check_mesh(device_mesh)
            d = axis_size(device_mesh, DATA_AXIS)
            vc = -(-config.view_chunk // d) * d
            if vc != config.view_chunk:
                config = dataclasses.replace(config, view_chunk=vc)
            self._writer = dist.get_rank() == 0
        self.config = config
        self.device = resolve_device(device)
        # annotation targets vs distractors: entries flagged distractor=True
        # (and everything in distractor_library) render and occlude but are
        # never annotated
        self._targets = [e for e in library.entries if not e.get("distractor")]
        self._distract = [e for e in library.entries if e.get("distractor")]
        if distractor_library is not None:
            self._distract += list(distractor_library.entries)
        if not self._targets:
            raise ValueError("library has no non-distractor entries")
        if config.distractors_per_scene[1] > 0 and not self._distract:
            raise ValueError(
                "distractors_per_scene > 0 but no distractor entries: flag "
                "library entries {'distractor': True} or pass "
                "distractor_library")
        H, W = config.image_size
        f = config.focal_scale * min(H, W)
        self.K = np.array(
            [[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]], np.float32)
        # static scene padding budget: every sampled scene has one shape
        # (max objects x largest library entry, plus the distractor budget)
        n_max = config.objects_per_scene[1]
        self._pad_verts = n_max * max(
            e["verts"].shape[0] for e in self._targets)
        self._pad_faces = n_max * max(
            np.asarray(e["faces"]).shape[0] for e in self._targets)
        nd_max = config.distractors_per_scene[1]
        if nd_max > 0:
            self._pad_verts += nd_max * max(
                e["verts"].shape[0] for e in self._distract)
            self._pad_faces += nd_max * max(
                np.asarray(e["faces"]).shape[0] for e in self._distract)
        if config.room:
            rv, rf = room_planes(config.room_extent, config.room_height)
            self._room_geom = (rv, rf)
            self._pad_verts += rv.shape[0]
            self._pad_faces += rf.shape[0]
        else:
            self._room_geom = None
        # max_faces_per_bin is a floor: render_scene measures each scene's
        # true largest tile occupancy (count_overflow) and grows the budget
        # monotonically, since an overflowing bin drops faces silently
        self._mfb = config.max_faces_per_bin
        self._vis_mfb = config.max_faces_per_bin
        self._vis_scale = 4
        # texture image pool (resized lazily to the tile size) and a cache
        # of resized tiles
        self._texture_pool: list = []
        if config.texture_dir:
            import glob

            from ..io.obj import _load_image

            exts = ("*.png", "*.jpg", "*.jpeg", "*.bmp")
            files = sorted(sum(
                (glob.glob(os.path.join(config.texture_dir, e))
                 for e in exts), []))
            self._texture_pool = [
                im for im in (_load_image(p) for p in files) if im is not None]
            if not self._texture_pool:
                raise ValueError(
                    f"texture_dir {config.texture_dir!r} contains no "
                    "readable images")
        self._tile_cache: Dict = {}
        self._build_renderers()
        self._settler = None
        if config.placement_mode == "physics":
            from .physics import SettleConfig, collision_proxies

            self._proxies = [
                collision_proxies(
                    np.asarray(e["verts"], np.float32) * config.object_scale)
                for e in self._targets + self._distract
            ]
            self._settle_cfg = SettleConfig(
                extent=config.placement_extent + config.object_scale)
        elif config.placement_mode != "rest":
            raise ValueError(
                f"placement_mode must be 'rest' or 'physics', "
                f"got {config.placement_mode!r}")

    def _build_renderers(self) -> None:
        """(Re)build the full-size renderer and, when the camera visibility
        check is on, the quarter-size seg-count renderer, at the current
        bin budgets."""
        config = self.config
        H, W = config.image_size
        self.renderer = MeshRenderer(
            self.K, (H, W), faces_per_pixel=1, bin_size=config.bin_size,
            max_faces_per_bin=self._mfb,
            active_tiles=config.active_tiles or None,
            select_impl=config.select_impl, pixel_chunk=131072,
            device=self.device)
        if config.min_visible_px > 0:
            vs = self._vis_scale
            Kv = self.K.copy()
            Kv[:2] /= vs
            self._vis_renderer = MeshRenderer(
                Kv, (max(1, H // vs), max(1, W // vs)), faces_per_pixel=1,
                bin_size=16, max_faces_per_bin=self._vis_mfb,
                select_impl=config.select_impl, pixel_chunk=131072,
                device=self.device)

    @torch.no_grad()
    def _vis_counts(self, batched, Rs, ts, face_to_object) -> torch.Tensor:
        """(B, n_max) pixel count of each object in the quarter-size
        render of every candidate view (one batched render)."""
        n_max = self.config.objects_per_scene[1]
        frags, _ = self._vis_renderer.rasterize(batched, Rs, ts)
        return instance_masks(frags, face_to_object, n_max).sum(dim=(-2, -1))

    @torch.no_grad()
    def _ensure_bin_capacity(self, meshes_batched, Rs, ts) -> None:
        """Grow the bin budgets to the scene's views' true largest tile
        occupancy with 1.3x head-room (a host read once a scene, outside
        any render; monotonic). The quarter-size visibility renderer has
        its own budget: its 16-pixel tiles cover a 4x larger footprint than
        the full-size tiles, so its occupancy is much higher."""
        from ..rasterize.binning import count_overflow
        from ..rasterize.geometry import setup_face_planes

        cam = self.renderer.camera_with_pose(Rs, ts)
        fd = setup_face_planes(meshes_batched, cam)
        changed = False
        mx, _ = count_overflow(fd, self.renderer.image_size,
                               self.config.bin_size, 0, 0.0)
        need = _bin_need(float(mx))
        if need > self._mfb:
            self._mfb = need
            changed = True
        if self.config.min_visible_px > 0:
            vcam = self._vis_renderer.camera_with_pose(Rs, ts)
            vfd = setup_face_planes(meshes_batched, vcam)
            vmx, _ = count_overflow(vfd, self._vis_renderer.image_size, 16,
                                    0, 0.0)
            vneed = _bin_need(float(vmx))
            if vneed > self._vis_mfb:
                self._vis_mfb = vneed
                changed = True
        if changed:
            self._build_renderers()

    @torch.no_grad()
    def _render_views(self, batched, Rs, ts, lights, face_to_object):
        """One chunk: K=1 raster, hard Phong rgb, depth, camera-space
        normals, instance ids; packed on the device unless pack_outputs is
        off; Canny edges on the device when edge_maps is set."""
        from ..shading.phong import hard_phong_shader

        frags, cam = self.renderer.rasterize(batched, Rs, ts)
        rgba = hard_phong_shader(batched, frags, cam, lights,
                                 self.renderer.materials, self.renderer.blend)
        rgb = rgba[..., :3]
        depth = frags.depth()
        want_normals = self.config.normal_maps
        normals = (render_normals(batched, frags, cam, space="camera")
                   if want_normals else None)
        seg = instance_segmentation(frags, face_to_object)
        if not self.config.pack_outputs:
            return tuple(x for x in (rgb, depth, normals, seg)
                         if x is not None)
        rgb_u8 = torch.round(rgb.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        depth_u16 = torch.round(
            (depth * DEPTH_SCALE).clamp(0.0, 65535.0)).to(torch.uint16)
        seg_u8 = torch.where(seg < 0, torch.full_like(seg, SEG_BACKGROUND),
                             seg).to(torch.uint8)
        if want_normals:
            normals_i8 = torch.round(
                normals.clamp(-1.0, 1.0) * 127.0).to(torch.int8)
            outs = (rgb_u8, depth_u16, normals_i8, seg_u8)
        else:
            outs = (rgb_u8, depth_u16, seg_u8)
        if self.config.edge_maps:
            from ..ops.canny import canny_edges

            edges = canny_edges(rgb * 255.0, low_threshold=20.0).thresholded
            outs = outs + (
                torch.round(edges.clamp(0.0, 255.0)).to(torch.uint8),)
        return outs

    # -- scene sampling ------------------------------------------------------
    def _object_colors(self, rng: np.random.Generator,
                       verts: np.ndarray) -> np.ndarray:
        mode = self.config.material_mode
        if mode == "random":
            mode = rng.choice(["vertex", "uniform"])
        if mode == "uniform":
            return np.tile(rng.uniform(0.15, 0.95, 3).astype(np.float32),
                           (verts.shape[0], 1))
        base = rng.uniform(0.1, 0.9, 3).astype(np.float32)
        jitter = 0.5 + 0.5 * np.tanh(verts * rng.uniform(1.0, 4.0))
        return np.clip(base[None] * jitter, 0.0, 1.0).astype(np.float32)

    def _object_tile(self, rng: np.random.Generator, entry: Dict) -> np.ndarray:
        """Texture tile for one object: the entry's own texture (resized
        once and cached), else a texture_dir image, else a procedural
        pattern."""
        tex = entry.get("texture")
        if tex is not None:
            key = id(entry)
            if key not in self._tile_cache:
                self._tile_cache[key] = resize_texture(
                    tex, self.config.texture_size)
            return self._tile_cache[key]
        return self._pool_or_procedural_tile(rng)

    def _pool_or_procedural_tile(self, rng: np.random.Generator) -> np.ndarray:
        if self._texture_pool:
            i = int(rng.integers(0, len(self._texture_pool)))
            key = ("pool", i)
            if key not in self._tile_cache:
                self._tile_cache[key] = resize_texture(
                    self._texture_pool[i], self.config.texture_size)
            return self._tile_cache[key]
        return random_texture(rng, self.config.texture_size)

    def _settle_scene(self, rng: np.random.Generator, picks, xy):
        """Physics placement: drop the picked objects at the sampled xy with
        random orientations, settle them, and return (R (n, 3, 3), t (n, 3))
        resting poses. The sim always runs the largest body count (padding
        bodies frozen), so one Settler (one capture) serves every scene."""
        from .physics import Settler, drop_poses

        n_max = (self.config.objects_per_scene[1]
                 + self.config.distractors_per_scene[1])
        n = len(picks)
        pad_pick = int(picks[0])
        idx = [int(p) for p in picks] + [pad_pick] * (n_max - n)
        pts = np.stack([self._proxies[j][0] for j in idx])
        radii = np.array([self._proxies[j][2] for j in idx], np.float32)
        xy_full = np.concatenate(
            [np.asarray(xy, np.float32),
             np.zeros((n_max - n, 2), np.float32)], axis=0)
        p0, q0 = drop_poses(rng, n_max, xy_full, radii)
        active = np.array([1.0] * n + [0.0] * (n_max - n), np.float32)
        if self._settler is None:
            self._settler = Settler(n_max, pts.shape[1], self._settle_cfg,
                                    self.device)
        R, t, _ = self._settler.settle(pts, radii, p0, q0, active)
        return R.cpu().numpy()[:n], t.cpu().numpy()[:n]

    def sample_scene(self, rng: np.random.Generator):
        """Returns (SceneMeshes, object_poses list of dicts)."""
        cfg = self.config
        lo, hi = cfg.objects_per_scene
        n = int(rng.integers(lo, hi + 1))
        d_lo, d_hi = cfg.distractors_per_scene
        n_d = int(rng.integers(d_lo, d_hi + 1)) if d_hi > 0 else 0
        # one combined pick list: targets index self._targets, distractors
        # index self._distract offset by len(self._targets)
        picks = list(rng.integers(0, len(self._targets), n))
        if n_d:
            picks += [
                len(self._targets) + int(p)
                for p in rng.integers(0, len(self._distract), n_d)
            ]
        entries_all = self._targets + self._distract
        xy = sample_nonoverlapping_xy(
            rng, n + n_d, radius=cfg.object_scale, extent=cfg.placement_extent)
        # image-texture materials are a per-scene choice (TexturesUV or
        # TexturesVertex); each object gets its own atlas tile
        textured = cfg.material_mode == "texture" or (
            cfg.material_mode == "random" and rng.uniform() < 0.5)

        settled = (self._settle_scene(rng, picks, xy)
                   if cfg.placement_mode == "physics" else None)

        verts_list, faces_list, colors_list, cats, poses = [], [], [], [], []
        tiles, uvs_list = [], []
        for i, pick in enumerate(picks):
            entry = entries_all[int(pick)]
            annotated = i < n  # distractors follow the targets in the list
            if settled is not None:
                R, t_i = settled[0][i], settled[1][i]
                com = self._proxies[int(pick)][1]
                v = (np.asarray(entry["verts"], np.float32) * cfg.object_scale
                     - com) @ R.T + t_i
            else:
                yaw = rng.uniform(0.0, 2 * np.pi)
                R = euler_angles_to_matrix(
                    torch.tensor([0.0, 0.0, yaw], dtype=torch.float32),
                    "XYZ").numpy()
                v = place_on_plane(
                    np.asarray(entry["verts"]) * cfg.object_scale, R, xy[i])
            verts_list.append(v)
            faces_list.append(np.asarray(entry["faces"]))
            if textured:
                tiles.append(self._object_tile(rng, entry))
                uvs_list.append(
                    np.asarray(entry["verts_uvs"], np.float32)
                    if entry.get("texture") is not None
                    else planar_uvs(rng, entry["verts"]))
            else:
                colors_list.append(self._object_colors(rng, v))
            cats.append(entry["category_id"] if annotated else 0)
            if annotated:
                t = v.mean(axis=0)
                poses.append({
                    "category_id": int(entry["category_id"]),
                    "name": entry["name"],
                    "R": R.tolist(), "t": t.tolist(),
                })
        if self._room_geom is not None:
            # the room rides as one extra merged object last (instance id
            # n + n_d): in rgb/depth/normals/seg, never annotated
            rv, rf = self._room_geom
            verts_list.append(rv)
            faces_list.append(rf)
            cats.append(0)  # background category
            if textured:
                tiles.append(self._pool_or_procedural_tile(rng))
                uvs_list.append(planar_uvs(rng, rv))
            else:
                gray = rng.uniform(0.25, 0.8)
                tint = rng.uniform(0.85, 1.0, 3)
                colors_list.append(np.tile(
                    (gray * tint).astype(np.float32), (rv.shape[0], 1)))
        if textured:
            # pad to the largest object count, so the atlas shape does not
            # depend on the scene
            n_slots = (cfg.objects_per_scene[1] + cfg.distractors_per_scene[1]
                       + (1 if self._room_geom is not None else 0))
            while len(tiles) < n_slots:
                tiles.append(np.zeros_like(tiles[0]))
            atlas, packed_uvs = pack_atlas(tiles, uvs_list + [
                np.zeros((0, 2), np.float32)] * (n_slots - len(uvs_list)))
            scene = merge_meshes(
                verts_list, faces_list, None, cats,
                pad_verts_to=self._pad_verts, pad_faces_to=self._pad_faces,
                uvs_list=packed_uvs[:len(verts_list)], texture_map=atlas,
                device=self.device)
        else:
            scene = merge_meshes(
                verts_list, faces_list, colors_list, cats,
                pad_verts_to=self._pad_verts, pad_faces_to=self._pad_faces,
                device=self.device)
        scene = dataclasses.replace(scene, n_annotated=n)
        return scene, poses

    # -- camera sampling -----------------------------------------------------
    def _object_centers(self, scene: SceneMeshes) -> np.ndarray:
        """(n_obj, 3) centroid per annotated object (room and padding
        excluded), on the host from the merged mesh and its face-to-object
        table."""
        n_obj = self._n_annotated(scene)
        v = scene.meshes.verts[0].cpu().numpy()
        fcs = scene.meshes.faces[0].cpu().numpy()
        f2o = scene.face_to_object.cpu().numpy()
        out = []
        for o in range(n_obj):
            vid = np.unique(fcs[f2o == o])
            out.append(v[vid].mean(0) if vid.size else np.zeros(3, np.float32))
        return (np.stack(out).astype(np.float32)
                if out else np.zeros((0, 3), np.float32))

    def _n_annotated(self, scene: SceneMeshes) -> int:
        if scene.n_annotated is not None:
            return scene.n_annotated
        return len(scene.object_categories) - (
            1 if self._room_geom is not None else 0)

    def _sample_view_poses(self, rng: np.random.Generator, n: int,
                           obj_centers: np.ndarray):
        """n look-at shell poses; camera centers keep cam_clearance from
        every object centroid (rejection-resampled on the host)."""
        cfg = self.config
        # look at the scene's point of interest, with the camera shell
        # centered slightly above the ground
        poi = np.array([0.0, 0.0, cfg.object_scale], np.float32)

        def draw(k):
            # the shell in the Z-up scene frame: elevation is height above
            # the ground plane, so cameras stay above the floor
            dist = rng.uniform(*cfg.camera_dist, k).astype(np.float32)
            elev = np.radians(rng.uniform(*cfg.camera_elev, k)).astype(
                np.float32)
            azim = np.radians(rng.uniform(-180.0, 180.0, k)).astype(
                np.float32)
            roll = rng.uniform(
                -np.radians(cfg.max_inplane_deg),
                np.radians(cfg.max_inplane_deg), k,
            ).astype(np.float32)
            eye = poi[None] + np.stack([
                dist * np.cos(elev) * np.cos(azim),
                dist * np.cos(elev) * np.sin(azim),
                dist * np.sin(elev),
            ], axis=-1)
            R, t = look_at_opencv(eye, np.repeat(poi[None], k, axis=0),
                                  (0.0, 0.0, 1.0))
            c, s = np.cos(roll), np.sin(roll)
            zero, one = np.zeros_like(c), np.ones_like(c)
            Rz = np.stack(
                [c, -s, zero, s, c, zero, zero, zero, one], axis=-1
            ).reshape(k, 3, 3)
            R = np.asarray(Rz @ R.numpy(), np.float32)
            t = np.asarray(np.einsum("nij,nj->ni", Rz, t.numpy()), np.float32)
            return R, t

        Rs, ts = draw(n)
        if cfg.cam_clearance > 0 and len(obj_centers):
            for _ in range(64):  # on the host; never renders
                C = -np.einsum("nji,nj->ni", Rs, ts)  # camera centers, world
                d = np.linalg.norm(
                    C[:, None, :] - obj_centers[None], axis=-1).min(axis=1)
                bad = d < cfg.cam_clearance
                if not bad.any():
                    break
                Rs[bad], ts[bad] = draw(int(bad.sum()))
            else:
                import warnings

                warnings.warn(
                    f"{int(bad.sum())} camera pose(s) still within "
                    f"cam_clearance={cfg.cam_clearance} m of an object "
                    "after 64 resample rounds (crowded scene?); keeping "
                    "the closest draws: widen camera_dist or shrink the "
                    "clearance", stacklevel=2)
        return Rs, ts

    # -- rendering -----------------------------------------------------------
    def _full_render(self, batched, Rs, ts, lights, f2o) -> List[np.ndarray]:
        """Render every view in chunks of view_chunk (the tail repeat-padded
        to a whole chunk and cut on the device). Every chunk is started
        before the host waits: each output is copied into pinned host
        memory without blocking, and the host waits once, after the last
        chunk. "warn" budget checks are deferred to that wait
        (binning.deferred_budget_checks)."""
        from ..rasterize.binning import deferred_budget_checks

        parts, index = 1, 0
        if self.device_mesh is not None:
            from ..parallel.mesh import (
                DATA_AXIS,
                all_gather_batch,
                axis_index,
                axis_size,
            )

            parts = axis_size(self.device_mesh, DATA_AXIS)
            index = axis_index(self.device_mesh, DATA_AXIS)
        vl = batched.batch_size           # views this rank renders a chunk
        vc = vl * parts
        nr = Rs.shape[0]
        idx = [min(i, nr - 1) for i in range(-(-nr // vc) * vc)]
        Rd = torch.as_tensor(Rs[idx], device=self.device)
        td = torch.as_tensor(ts[idx], device=self.device)
        cuda = self.device.type == "cuda"
        pending = []
        with deferred_budget_checks():
            for v0 in range(0, nr, vc):
                a = v0 + index * vl
                chunk = self._render_views(batched, Rd[a:a + vl],
                                           td[a:a + vl], lights, f2o)
                if parts > 1:
                    chunk = all_gather_batch(chunk, self.device_mesh)
                keep = min(vc, nr - v0)
                host = []
                for arr in chunk:
                    arr = arr[:keep]
                    if cuda:
                        h = torch.empty(arr.shape, dtype=arr.dtype,
                                        pin_memory=True)
                        h.copy_(arr, non_blocking=True)
                    else:
                        h = arr
                    host.append(h)
                pending.append(host)
            if cuda:
                torch.cuda.current_stream(self.device).synchronize()
        return [np.concatenate([c[i].numpy() for c in pending])
                for i in range(len(pending[0]))]

    def render_scene(self, scene: SceneMeshes, rng: np.random.Generator) -> Dict:
        cfg = self.config
        n = cfg.views_per_scene
        centers = (self._object_centers(scene)
                   if (cfg.cam_clearance > 0 or cfg.min_visible_px > 0)
                   else np.zeros((0, 3), np.float32))
        Rs, ts = self._sample_view_poses(rng, n, centers)
        # size the bins for this scene before any render (the quarter-size
        # visibility check too)
        self._ensure_bin_capacity(scene.meshes.extend(n), Rs, ts)
        if cfg.min_visible_px > 0:
            # quarter-size pre-check: re-sample views until at least
            # min_visible_objects instances clear the (resolution-scaled)
            # pixel threshold; the full-size annotations re-check exactly
            n_obj = self._n_annotated(scene)
            thresh = max(1, cfg.min_visible_px // (self._vis_scale ** 2))
            vb = scene.meshes.extend(n)
            for _ in range(cfg.cam_resample_rounds):
                counts = self._vis_counts(
                    vb, Rs, ts, scene.face_to_object).cpu().numpy()
                okv = ((counts[:, :n_obj] >= thresh).sum(axis=1)
                       >= min(cfg.min_visible_objects, n_obj))
                if okv.all():
                    break
                k = int((~okv).sum())
                Rn, tn = self._sample_view_poses(rng, k, centers)
                Rs[~okv], ts[~okv] = Rn, tn
            # re-sampled poses may shift tile occupancy past the budget
            self._ensure_bin_capacity(vb, Rs, ts)

        light_pos = rng.uniform(-1.5, 1.5, 3).astype(np.float32)
        light_pos[2] = abs(light_pos[2]) + 1.0
        intensity = rng.uniform(0.6, 1.0)
        lights = PointLights.make(
            location=(tuple(light_pos),),
            ambient=((0.45 * intensity,) * 3,),
            diffuse=((0.4 * intensity,) * 3,),
            specular=((0.15 * intensity,) * 3,),
            device=self.device)
        self.renderer.lights = lights

        f2o = scene.face_to_object
        if self.device_mesh is None:
            batched = scene.meshes.extend(min(cfg.view_chunk, n))
        else:   # this rank's share of a whole chunk of view_chunk views
            from ..parallel.mesh import DATA_AXIS, axis_size

            batched = scene.meshes.extend(
                cfg.view_chunk // axis_size(self.device_mesh, DATA_AXIS))
        stacked = self._full_render(batched, Rs, ts, lights, f2o)
        if cfg.min_visible_px > 0:
            # exact full-size guarantee: re-check each view's seg and
            # re-render re-sampled poses for the views still under the floor
            n_obj = self._n_annotated(scene)
            seg_i = -2 if (cfg.edge_maps and cfg.pack_outputs) else -1
            for _ in range(cfg.cam_resample_rounds):
                seg = stacked[seg_i]
                per_obj = np.stack(
                    [(seg == o).sum(axis=(1, 2)) for o in range(n_obj)],
                    axis=1)  # (n, n_obj)
                okv = ((per_obj >= cfg.min_visible_px).sum(axis=1)
                       >= min(cfg.min_visible_objects, n_obj))
                if okv.all():
                    break
                # re-render only the re-sampled views and splice them back
                bad = np.nonzero(~okv)[0]
                Rn, tn = self._sample_view_poses(rng, len(bad), centers)
                Rs[bad], ts[bad] = Rn, tn
                self._ensure_bin_capacity(scene.meshes.extend(len(bad)),
                                          Rn, tn)
                sub = self._full_render(batched, Rs[bad], ts[bad], lights,
                                        f2o)
                for col, scol in zip(stacked, sub):
                    col[bad] = scol

        names = ["rgb", "depth"]
        if cfg.normal_maps:
            names.append("normals")
        names.append("segmentation")
        if cfg.edge_maps and cfg.pack_outputs:
            names.append("edges")
        out = dict(zip(names, stacked))
        out.update({"R": np.asarray(Rs), "t": np.asarray(ts), "K": self.K,
                    "packed": bool(cfg.pack_outputs)})
        if not cfg.normal_maps:
            out["normals"] = None
        if cfg.edge_maps and not cfg.pack_outputs:
            from ..ops.canny import canny_edges

            out["edges"] = canny_edges(
                torch.as_tensor(out["rgb"], device=self.device) * 255.0,
                low_threshold=20.0).thresholded.cpu().numpy()
        return out

    # -- COCO annotation encoding (host side) --------------------------------
    @staticmethod
    def _mask_to_bbox(mask: np.ndarray) -> Optional[List[float]]:
        ys, xs = np.nonzero(mask)
        if ys.size == 0:
            return None
        x0, x1 = xs.min(), xs.max()
        y0, y1 = ys.min(), ys.max()
        return [float(x0), float(y0), float(x1 - x0 + 1), float(y1 - y0 + 1)]

    @staticmethod
    def _mask_to_rle(mask: np.ndarray) -> Dict:
        """Uncompressed COCO RLE (column-major counts): the native encoder
        when it builds (io/native.py), numpy otherwise."""
        from ..io.native import rle_encode as native_rle

        out = native_rle(mask)
        if out is not None:
            return out
        flat = np.asarray(mask, np.uint8).flatten(order="F")
        change = np.nonzero(np.diff(flat))[0] + 1
        runs = np.diff(np.concatenate([[0], change, [flat.size]]))
        counts = runs.tolist()
        if flat[0] == 1:  # COCO counts start with a zero-run
            counts = [0] + counts
        return {"size": list(mask.shape), "counts": counts}

    def generate(self, out_dir: str, n_scenes: int,
                 rng: Optional[np.random.Generator] = None,
                 write_aux: bool = True) -> Dict:
        """Render n_scenes scenes and write a COCO dataset under out_dir:
        images/*.png, optional depth/normals/seg .npy (aux/),
        annotations.json, poses.json (6-DoF labels). Returns the COCO
        dict."""
        import concurrent.futures

        rng = rng or np.random.default_rng(0)
        cfg = self.config
        write = self._writer      # with a device_mesh, rank 0 alone writes
        write_aux = write_aux and write
        if write:
            os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
        if write_aux:
            os.makedirs(os.path.join(out_dir, "aux"), exist_ok=True)
        # image and aux writes overlap the next scene's rendering
        io_pool = concurrent.futures.ThreadPoolExecutor(max_workers=8)
        io_futures = []

        cats = {}
        for e in self._targets:  # distractors never enter the table
            cats[e["category_id"]] = {
                "id": int(e["category_id"]), "name": e["name"],
                "supercategory": e.get("supercategory", "object"),
            }
        coco = {"images": [], "annotations": [],
                "categories": list(cats.values())}
        if getattr(self.library, "dataset_name", None):
            coco["info"] = {"description": self.library.dataset_name}
        all_poses = []
        img_id = 0
        ann_id = 0
        H, W = cfg.image_size

        def aux(fname, suffix, arr):
            io_futures.append(io_pool.submit(
                np.save, os.path.join(out_dir, "aux",
                                      fname.replace(".png", suffix)), arr))

        for s in range(n_scenes):
            scene, poses = self.sample_scene(rng)
            rendered = self.render_scene(scene, rng)
            rgb = rendered["rgb"]
            seg = rendered["segmentation"]
            n_obj = len(poses)
            for v in range(cfg.views_per_scene):
                fname = f"scene{s:04d}_view{v:03d}.png"
                if write:
                    io_futures.append(io_pool.submit(
                        self._write_png,
                        os.path.join(out_dir, "images", fname), rgb[v]))
                if write_aux:
                    aux(fname, "_depth.npy", rendered["depth"][v])
                    aux(fname, "_seg.npy", seg[v])
                    if rendered.get("normals") is not None:
                        aux(fname, "_normals.npy", rendered["normals"][v])
                coco["images"].append({
                    "id": img_id, "file_name": f"images/{fname}",
                    "height": H, "width": W,
                })
                for o in range(n_obj):
                    mask = seg[v] == o
                    frac = mask.mean()
                    if frac < cfg.min_visibility:
                        continue
                    if cfg.min_visible_px > 0 and mask.sum() < cfg.min_visible_px:
                        continue  # the per-annotation pixel guarantee
                    bbox = self._mask_to_bbox(mask)
                    if bbox is None:
                        continue
                    coco["annotations"].append({
                        "id": ann_id, "image_id": img_id,
                        "category_id": poses[o]["category_id"],
                        "bbox": bbox, "area": float(mask.sum()),
                        "iscrowd": 0,
                        "segmentation": self._mask_to_rle(mask),
                    })
                    ann_id += 1
                all_poses.append({
                    "image_id": img_id,
                    "cam_R": rendered["R"][v].tolist(),
                    "cam_t": rendered["t"][v].tolist(),
                    "K": rendered["K"].tolist(),
                    "objects": poses,
                })
                img_id += 1

        for fut in io_futures:  # surface any IO error before declaring done
            fut.result()
        io_pool.shutdown()
        if write:
            with open(os.path.join(out_dir, "annotations.json"), "w") as f:
                json.dump(coco, f)
            with open(os.path.join(out_dir, "poses.json"), "w") as f:
                json.dump(all_poses, f)
        return coco

    @staticmethod
    def _write_png(path: str, rgb: np.ndarray) -> None:
        if rgb.dtype != np.uint8:
            rgb = (np.clip(rgb, 0.0, 1.0) * 255).astype(np.uint8)
        # the native encoder first (its C call releases the GIL, so writer
        # threads overlap the next scene's rendering), then io/png.py
        from ..io.native import png_write
        from ..io.png import write_png

        if not png_write(path, rgb):
            write_png(path, rgb)


def reformat_coco_annotations(coco: Dict) -> Dict:
    """Remap category ids to contiguous 1..N (the reference's
    reformat_coco_anns for detectron2)."""
    old_ids = sorted({c["id"] for c in coco["categories"]})
    remap = {old: i + 1 for i, old in enumerate(old_ids)}
    return {
        "images": coco["images"],
        "categories": [{**c, "id": remap[c["id"]]} for c in coco["categories"]],
        "annotations": [{**a, "category_id": remap[a["category_id"]]}
                        for a in coco["annotations"]],
    }

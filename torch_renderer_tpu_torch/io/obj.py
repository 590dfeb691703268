"""Wavefront OBJ / MTL load and save, on the host (PyTorch counterpart of
``torch_renderer_tpu.io.obj``; pytorch3d's load_obj, load_objs_as_meshes and
save_obj), including an MTL's map_Kd texture image.

The native C++ parser (io/native_obj.py, built at first use into
build/native/) parses when it builds, the pure-Python parser otherwise.
Texture images are read with PIL where it is
importable (None otherwise); save_obj writes its PNG with io/png.py (zlib and
struct from the standard library), so saving needs no imaging package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

from ..structures.meshes import Meshes
from ..structures.textures import TexturesUV, TexturesVertex
from .png import write_png


@dataclasses.dataclass
class ObjData:
    verts: np.ndarray                       # (V, 3) float32
    faces: np.ndarray                       # (F, 3) int32 vertex indices
    verts_uvs: Optional[np.ndarray] = None  # (VT, 2) float32
    faces_uvs: Optional[np.ndarray] = None  # (F, 3) int32 into verts_uvs
    normals: Optional[np.ndarray] = None    # (VN, 3)
    texture_image: Optional[np.ndarray] = None  # (Hm, Wm, 3) float32 in [0,1]
    mtl_path: Optional[str] = None


def _parse_mtl_texture(mtl_path: str) -> Optional[str]:
    """The map_Kd path of an MTL file, if any."""
    if not os.path.exists(mtl_path):
        return None
    with open(mtl_path, "r", errors="ignore") as f:
        for line in f:
            tok = line.strip().split()
            if len(tok) >= 2 and tok[0].lower() == "map_kd":
                return os.path.join(os.path.dirname(mtl_path), tok[-1])
    return None


def _load_image(path: str) -> Optional[np.ndarray]:
    """(H, W, 3) float32 in [0, 1], or None without PIL or a readable
    image."""
    try:
        from PIL import Image
    except ImportError:
        return None
    try:
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    except OSError:
        return None


def _triangulate(idx: List[int]) -> List[Tuple[int, int, int]]:
    """Fan-triangulate a polygon's index list."""
    return [(idx[0], idx[i], idx[i + 1]) for i in range(1, len(idx) - 1)]


def load_obj(path: str, load_textures: bool = True) -> ObjData:
    """Parse an OBJ file (v / vt / vn / f with the v, v/t, v/t/n and v//n
    forms; polygons are fan-triangulated)."""
    from . import native_obj

    parsed = native_obj.parse_obj(path)
    if parsed is not None:
        return _attach_texture(ObjData(**parsed), path, load_textures)
    verts, uvs, normals = [], [], []
    faces_v, faces_t = [], []
    mtl_file = None
    with open(path, "r", errors="ignore") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            key = tok[0]
            if key == "v":
                verts.append([float(x) for x in tok[1:4]])
            elif key == "vt":
                uvs.append([float(x) for x in tok[1:3]])
            elif key == "vn":
                normals.append([float(x) for x in tok[1:4]])
            elif key == "f":
                vi, ti = [], []
                for part in tok[1:]:
                    comp = part.split("/")
                    i = int(comp[0])
                    vi.append(i - 1 if i > 0 else len(verts) + i)
                    if len(comp) > 1 and comp[1]:
                        ti.append(int(comp[1]) - 1)
                faces_v.extend(_triangulate(vi))
                if len(ti) == len(vi) and len(ti) >= 3:
                    faces_t.extend(_triangulate(ti))
            elif key == "mtllib":
                mtl_file = os.path.join(os.path.dirname(path), tok[1])
    data = ObjData(
        verts=np.asarray(verts, np.float32).reshape(-1, 3),
        faces=np.asarray(faces_v, np.int32).reshape(-1, 3),
        verts_uvs=np.asarray(uvs, np.float32) if uvs else None,
        faces_uvs=(np.asarray(faces_t, np.int32)
                   if faces_t and len(faces_t) == len(faces_v) else None),
        normals=np.asarray(normals, np.float32) if normals else None,
        mtl_path=mtl_file,
    )
    return _attach_texture(data, path, load_textures)


def _attach_texture(data: ObjData, obj_path: str,
                    load_textures: bool) -> ObjData:
    if not load_textures:
        return data
    mtl = data.mtl_path
    if mtl is None:
        guess = os.path.splitext(obj_path)[0] + ".mtl"
        mtl = guess if os.path.exists(guess) else None
    if mtl is not None:
        tex_path = _parse_mtl_texture(mtl)
        if tex_path is not None and os.path.exists(tex_path):
            data.texture_image = _load_image(tex_path)
            data.mtl_path = mtl
    return data


def _pad(a: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n,) + a.shape[1:], a.dtype)
    out[:a.shape[0]] = a
    return out


def load_objs_as_meshes(paths: List[str], load_textures: bool = True,
                        device=None) -> Meshes:
    """Batch OBJ files into one padded Meshes on ``device`` (default: the
    card), with a TexturesUV when every file has a texture image and UVs,
    else white TexturesVertex (pytorch3d's load_objs_as_meshes)."""
    import torch

    objs = [load_obj(p, load_textures) for p in paths]
    if load_textures and all(o.texture_image is not None
                             and o.faces_uvs is not None for o in objs):
        Hm = max(o.texture_image.shape[0] for o in objs)
        Wm = max(o.texture_image.shape[1] for o in objs)
        VT = max(o.verts_uvs.shape[0] for o in objs)
        F = max(o.faces.shape[0] for o in objs)
        maps = np.zeros((len(objs), Hm, Wm, 3), np.float32)
        for i, o in enumerate(objs):
            h, w = o.texture_image.shape[:2]
            maps[i, :h, :w] = o.texture_image
        textures = TexturesUV(
            maps=torch.from_numpy(maps),
            faces_uvs=torch.from_numpy(np.stack(
                [_pad(o.faces_uvs, F) for o in objs]).astype(np.int64)),
            verts_uvs=torch.from_numpy(np.stack(
                [_pad(o.verts_uvs, VT) for o in objs])))
    else:
        V = max(o.verts.shape[0] for o in objs)
        textures = TexturesVertex(torch.ones((len(objs), V, 3)))
    return Meshes.from_lists([o.verts for o in objs],
                             [o.faces for o in objs], device=device,
                             textures=textures)


def _write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) image in [0, 1] as an 8-bit RGB PNG (values
    clipped, scaled by 255 and truncated, as the JAX package writes them)."""
    write_png(path, (np.clip(image, 0, 1) * 255).astype(np.uint8))


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray,
             verts_uvs: Optional[np.ndarray] = None,
             faces_uvs: Optional[np.ndarray] = None,
             texture_image: Optional[np.ndarray] = None,
             verts_rgb: Optional[np.ndarray] = None) -> None:
    """Save a mesh as OBJ (+ MTL and PNG when a texture map is given;
    per-vertex colors are written as xyzrgb ``v`` lines, the common
    extension)."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64)
    mtl_name = None
    if texture_image is not None:
        base = os.path.splitext(path)[0]
        mtl_name = os.path.basename(base) + ".mtl"
        _write_png(base + ".png", np.asarray(texture_image))
        with open(base + ".mtl", "w") as f:
            f.write("newmtl material_0\nmap_Kd {}\n".format(
                os.path.basename(base) + ".png"))
    with open(path, "w") as f:
        if mtl_name:
            f.write(f"mtllib {mtl_name}\nusemtl material_0\n")
        for i, v in enumerate(verts):
            if verts_rgb is not None:
                c = verts_rgb[i]
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f} "
                        f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n")
            else:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if verts_uvs is not None:
            for uv in verts_uvs:
                f.write(f"vt {uv[0]:.6f} {uv[1]:.6f}\n")
        if faces_uvs is not None and verts_uvs is not None:
            for fv, ft in zip(faces, faces_uvs):
                f.write("f {}/{} {}/{} {}/{}\n".format(
                    fv[0] + 1, ft[0] + 1, fv[1] + 1, ft[1] + 1, fv[2] + 1,
                    ft[2] + 1))
        else:
            for fv in faces:
                f.write(f"f {fv[0] + 1} {fv[1] + 1} {fv[2] + 1}\n")

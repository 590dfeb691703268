"""PLY point-cloud / mesh IO on the host, in numpy (PyTorch counterpart of
``torch_renderer_tpu.io.ply``, of which it is a copy).

The reference exports final_model.ply via open3d (SURVEY.md §2b artifacts;
deform_mesh_from_pcd.py's open3d color-reattach path writes PLY). Supports
ascii and binary_little_endian, vertices with optional colors/normals, and
triangular faces.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional

import numpy as np

_DTYPES = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
}


def load_ply(path: str) -> Dict[str, Optional[np.ndarray]]:
    """Returns dict(verts (V,3) f32, faces (F,3) i32 | None,
    colors (V,3) f32 in [0,1] | None, normals (V,3) f32 | None)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype) or ('list', idx_t, cnt_t, name)])
        cur = None
        while True:
            line = f.readline().strip().decode()
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                cur = (parts[1], int(parts[2]), [])
                elements.append(cur)
            elif parts[0] == "property":
                if parts[1] == "list":
                    cur[2].append(("list", _DTYPES[parts[2]], _DTYPES[parts[3]], parts[4]))
                else:
                    cur[2].append((parts[2], _DTYPES[parts[1]]))

        out: Dict[str, Optional[np.ndarray]] = {
            "verts": None, "faces": None, "colors": None, "normals": None
        }
        for name, count, props in elements:
            if name == "vertex":
                if fmt == "ascii":
                    rows = np.loadtxt(
                        [f.readline() for _ in range(count)], dtype=np.float64
                    ).reshape(count, len(props))
                else:
                    endian = "<" if "little" in fmt else ">"
                    dt = np.dtype([(p[0], endian + p[1]) for p in props])
                    rows_s = np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
                    rows = np.stack(
                        [rows_s[p[0]].astype(np.float64) for p in props], axis=-1
                    )
                cols = {p[0]: i for i, p in enumerate(props)}
                out["verts"] = rows[:, [cols["x"], cols["y"], cols["z"]]].astype(np.float32)
                if "red" in cols:
                    c = rows[:, [cols["red"], cols["green"], cols["blue"]]]
                    out["colors"] = (c / 255.0 if c.max() > 1.0 else c).astype(np.float32)
                if "nx" in cols:
                    out["normals"] = rows[:, [cols["nx"], cols["ny"], cols["nz"]]].astype(np.float32)
            elif name == "face":
                faces = []
                if fmt == "ascii":
                    for _ in range(count):
                        vals = f.readline().split()
                        k = int(vals[0])
                        idx = [int(v) for v in vals[1 : 1 + k]]
                        for j in range(1, k - 1):  # fan triangulation
                            faces.append([idx[0], idx[j], idx[j + 1]])
                else:
                    endian = "<" if "little" in fmt else ">"
                    cnt_t, idx_t = props[0][1], props[0][2]
                    cnt_size = np.dtype(cnt_t).itemsize
                    idx_size = np.dtype(idx_t).itemsize
                    for _ in range(count):
                        k = int(np.frombuffer(f.read(cnt_size), endian + cnt_t)[0])
                        idx = np.frombuffer(f.read(idx_size * k), endian + idx_t)
                        for j in range(1, k - 1):
                            faces.append([int(idx[0]), int(idx[j]), int(idx[j + 1])])
                out["faces"] = np.asarray(faces, np.int32) if faces else None
        return out


def save_ply(
    path: str,
    verts: np.ndarray,
    faces: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
    binary: bool = True,
) -> None:
    """Write a mesh/point cloud as PLY; colors in [0,1] are stored as uchar."""
    verts = np.asarray(verts, np.float32)
    V = verts.shape[0]
    header = ["ply"]
    header.append(
        "format binary_little_endian 1.0" if binary else "format ascii 1.0"
    )
    header.append(f"element vertex {V}")
    header += ["property float x", "property float y", "property float z"]
    if normals is not None:
        header += ["property float nx", "property float ny", "property float nz"]
    if colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    if faces is not None:
        faces = np.asarray(faces, np.int32)
        header.append(f"element face {faces.shape[0]}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        c8 = (
            (np.clip(np.asarray(colors), 0, 1) * 255).astype(np.uint8)
            if colors is not None else None
        )
        if binary:
            for i in range(V):
                f.write(struct.pack("<3f", *verts[i]))
                if normals is not None:
                    f.write(struct.pack("<3f", *np.asarray(normals[i], np.float32)))
                if c8 is not None:
                    f.write(struct.pack("<3B", *c8[i]))
            if faces is not None:
                for face in faces:
                    f.write(struct.pack("<B3i", 3, *face))
        else:
            for i in range(V):
                row = list(map(float, verts[i]))
                if normals is not None:
                    row += list(map(float, normals[i]))
                line = " ".join(f"{x:.6f}" for x in row)
                if c8 is not None:
                    line += " " + " ".join(str(int(x)) for x in c8[i])
                f.write((line + "\n").encode())
            if faces is not None:
                for face in faces:
                    f.write(f"3 {face[0]} {face[1]} {face[2]}\n".encode())

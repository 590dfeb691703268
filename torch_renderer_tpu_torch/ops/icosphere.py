"""Primitive meshes (host-side numpy): the icosphere, the scene mesh of the
soft-silhouette bench, a cube and a quad. Same construction as
``torch_renderer_tpu.ops.icosphere``, so both packages build bit-identical
meshes."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def icosphere(level: int = 0, radius: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Subdivided icosahedron: returns (verts (V,3) f32, faces (F,3) i32).

    Level L has 20 * 4**L faces; level 3 (1280 faces) is the bench mesh.
    """
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )

    for _ in range(level):
        edge_mid = {}
        new_faces = []
        verts_list = [v for v in verts]

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = verts_list[a] + verts_list[b]
                m /= np.linalg.norm(m)
                edge_mid[key] = len(verts_list)
                verts_list.append(m)
            return edge_mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, dtype=np.int64)

    return (verts * radius).astype(np.float32), faces.astype(np.int32)


def cube(size: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Axis-aligned cube centred at the origin, 12 triangles."""
    s = size / 2.0
    verts = np.array(
        [
            [-s, -s, -s], [s, -s, -s], [s, s, -s], [-s, s, -s],
            [-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s],
        ],
        dtype=np.float32,
    )
    faces = np.array(
        [
            [0, 2, 1], [0, 3, 2],  # -z
            [4, 5, 6], [4, 6, 7],  # +z
            [0, 1, 5], [0, 5, 4],  # -y
            [3, 6, 2], [3, 7, 6],  # +y
            [0, 4, 7], [0, 7, 3],  # -x
            [1, 2, 6], [1, 6, 5],  # +x
        ],
        dtype=np.int32,
    )
    return verts, faces


def quad(size: float = 1.0, z: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """One square in the plane z = const (2 triangles)."""
    s = size / 2.0
    verts = np.array(
        [[-s, -s, z], [s, -s, z], [s, s, z], [-s, s, z]], dtype=np.float32
    )
    faces = np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int32)
    return verts, faces

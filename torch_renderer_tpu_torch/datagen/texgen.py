"""Procedural random texture synthesis + UV atlas packing for datagen
(PyTorch counterpart of ``torch_renderer_tpu.datagen.texgen``, of which it
is a copy: numpy only, on the host).

The reference's BlenderProc pipeline assigns each scene object a random
image-texture material sampled from a texture folder
(coco_data_generator.py:253-266 — `random.choice(texture_images)` applied as
the object's material). This environment ships no texture image library, so
the equivalent randomization axis is synthesized: each object gets its own
procedurally generated texture image (checker / stripes / multi-octave value
noise / gradient — the families that dominate real texture folders'
low-frequency content), planar-projected UVs with a random orientation, and
all per-object textures pack into ONE atlas so a merged multi-object scene
renders with a single TexturesUV (one map lookup per pixel, no per-object
branching inside the compiled render).

Everything here is host-side numpy executed once per scene sample; the
device only ever sees the finished atlas.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


def _two_colors(rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Random base color pair with guaranteed per-channel contrast."""
    c0 = rng.uniform(0.05, 0.95, 3)
    c1 = np.clip(
        c0 + rng.choice([-1.0, 1.0], 3) * rng.uniform(0.25, 0.7, 3), 0.0, 1.0
    )
    return c0.astype(np.float32), c1.astype(np.float32)


def _bilinear_upsample(g: np.ndarray, size: int) -> np.ndarray:
    """(r+1, r+1) grid -> (size, size) bilinear interpolation."""
    r = g.shape[0] - 1
    t = np.linspace(0.0, r, size)
    i0 = np.clip(t.astype(np.int64), 0, r - 1)
    f = (t - i0).astype(np.float32)
    rows = g[i0] * (1 - f[:, None]) + g[i0 + 1] * f[:, None]
    return rows[:, i0] * (1 - f[None, :]) + rows[:, i0 + 1] * f[None, :]


def checker_texture(rng: np.random.Generator, size: int = 128) -> np.ndarray:
    n = int(rng.integers(2, 9))
    c0, c1 = _two_colors(rng)
    yy, xx = np.mgrid[0:size, 0:size]
    mask = ((yy * n // size) + (xx * n // size)) % 2
    return np.where(mask[..., None] == 0, c0, c1).astype(np.float32)


def stripe_texture(rng: np.random.Generator, size: int = 128) -> np.ndarray:
    n = int(rng.integers(3, 13))
    angle = rng.uniform(0.0, np.pi)
    c0, c1 = _two_colors(rng)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    t = xx * math.cos(angle) + yy * math.sin(angle)
    mask = np.floor(t * n).astype(np.int64) % 2
    return np.where(mask[..., None] == 0, c0, c1).astype(np.float32)


def noise_texture(
    rng: np.random.Generator, size: int = 128, octaves: int = 4
) -> np.ndarray:
    """Multi-octave value noise blended between two random colors."""
    acc = np.zeros((size, size), np.float32)
    amp, total, res = 1.0, 0.0, 4
    for _ in range(octaves):
        g = rng.random((res + 1, res + 1)).astype(np.float32)
        acc += amp * _bilinear_upsample(g, size)
        total += amp
        amp *= 0.5
        res = min(res * 2, size)
    acc = (acc / total)[..., None]
    c0, c1 = _two_colors(rng)
    return (c0[None, None] * (1 - acc) + c1[None, None] * acc).astype(np.float32)


def gradient_texture(rng: np.random.Generator, size: int = 128) -> np.ndarray:
    angle = rng.uniform(0.0, 2 * np.pi)
    c0, c1 = _two_colors(rng)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)
    t = xx * math.cos(angle) + yy * math.sin(angle)
    t = ((t - t.min()) / max(t.max() - t.min(), 1e-6))[..., None]
    return (c0[None, None] * (1 - t) + c1[None, None] * t).astype(np.float32)


_FAMILIES = (checker_texture, stripe_texture, noise_texture, gradient_texture)


def random_texture(rng: np.random.Generator, size: int = 128) -> np.ndarray:
    """One random texture image (size, size, 3) f32 in [0, 1]."""
    return _FAMILIES[int(rng.integers(0, len(_FAMILIES)))](rng, size)


def planar_uvs(rng: np.random.Generator, verts: np.ndarray) -> np.ndarray:
    """Random-orientation planar UV projection of (V, 3) verts -> (V, 2) in
    [0, 1]^2.

    A random orthonormal frame (QR of a Gaussian matrix) picks the projection
    plane, so texture orientation is itself a randomization axis. Planar
    mapping has no seams (unlike spherical atan2 unwrapping) at the cost of
    stretch on silhouette-grazing faces — the right trade for randomized
    clutter data where the texture is noise, not a specific decal.
    """
    M = rng.standard_normal((3, 3))
    q, _ = np.linalg.qr(M)
    p = np.asarray(verts, np.float32) @ q[:, :2].astype(np.float32)
    lo, hi = p.min(axis=0), p.max(axis=0)
    return ((p - lo) / np.maximum(hi - lo, 1e-6)).astype(np.float32)


def resize_texture(img: np.ndarray, size: int) -> np.ndarray:
    """Bilinear-resize an (H0, W0, 3) f32 image to (size, size, 3) — pure
    numpy (real texture files enter the fixed-tile-size atlas through this;
    reference analog: Blender scales material images freely)."""
    img = np.asarray(img, np.float32)
    H0, W0 = img.shape[:2]
    if (H0, W0) == (size, size):
        return img

    def axis_coords(n0):
        c = (np.arange(size, dtype=np.float32) + 0.5) * n0 / size - 0.5
        c = np.clip(c, 0.0, n0 - 1)
        i0 = np.floor(c).astype(np.int64)
        i1 = np.minimum(i0 + 1, n0 - 1)
        return i0, i1, (c - i0).astype(np.float32)

    r0, r1, fr = axis_coords(H0)
    c0, c1, fc = axis_coords(W0)
    top = img[r0][:, c0] * (1 - fc)[None, :, None] \
        + img[r0][:, c1] * fc[None, :, None]
    bot = img[r1][:, c0] * (1 - fc)[None, :, None] \
        + img[r1][:, c1] * fc[None, :, None]
    return (top * (1 - fr)[:, None, None]
            + bot * fr[:, None, None]).astype(np.float32)


def pack_atlas(
    tiles: Sequence[np.ndarray],
    uvs_list: Sequence[np.ndarray],
    inset_texels: float = 1.5,
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Pack per-object texture tiles into one grid atlas; remap UVs into it.

    Returns (atlas (A, A, 3), remapped per-object UV arrays). UV convention
    matches structures.textures.TexturesUV.sample: u right, v up with v=0 the
    BOTTOM image row, and texel centers at u*(Wm-1). UVs are inset by
    `inset_texels` from each tile edge so bilinear lookups never blend across
    neighboring objects' tiles.
    """
    n = len(tiles)
    assert n == len(uvs_list) and n > 0
    ts = tiles[0].shape[0]
    assert all(t.shape == (ts, ts, 3) for t in tiles)
    G = math.ceil(math.sqrt(n))
    A = G * ts
    atlas = np.zeros((A, A, 3), np.float32)
    span = ts - 1 - 2 * inset_texels
    out_uvs: List[np.ndarray] = []
    for i, (tile, uv) in enumerate(zip(tiles, uvs_list)):
        gy, gx = divmod(i, G)
        r0, c0 = gy * ts, gx * ts
        atlas[r0:r0 + ts, c0:c0 + ts] = tile
        u = np.clip(np.asarray(uv, np.float32), 0.0, 1.0)
        col = c0 + inset_texels + u[:, 0] * span
        # local v=0 is the tile's bottom row (array row r0 + ts - 1)
        row = r0 + inset_texels + (1.0 - u[:, 1]) * span
        out_uvs.append(
            np.stack([col / (A - 1), 1.0 - row / (A - 1)], axis=1)
            .astype(np.float32)
        )
    return atlas, out_uvs

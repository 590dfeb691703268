"""Texture containers (PyTorch counterpart of
``torch_renderer_tpu.structures.textures``, pytorch3d's TexturesVertex and
TexturesUV).

Both are plain padded tensors; sampling happens in shading: barycentric
interpolation of per-vertex features, or of per-corner UVs followed by a
bilinear map lookup. Corners are taken by indexed gather. The JAX package's
one-hot MXU gathers (``ops.rowops``) and its 2-hot matmul sampler
(``_sample_matmul``) are TPU workarounds and are not carried over.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.cuda_texsample import sample_bilinear

SAMPLE_METHODS = ("auto", "gather", "matmul", "pallas")


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (B, N, C), idx (B, F, 3) -> (B, F, 3, C)."""
    B, F, _ = idx.shape
    C = table.shape[-1]
    flat = idx.reshape(B, 3 * F, 1).expand(B, 3 * F, C)
    return table.gather(1, flat).reshape(B, F, 3, C)


def _repeat(a: torch.Tensor, n: int) -> torch.Tensor:
    return torch.repeat_interleave(a, n, dim=0)


@dataclasses.dataclass(frozen=True)
class TexturesVertex:
    """Per-vertex features (usually RGB): (B, V, C)."""

    verts_features: torch.Tensor

    def extend(self, n: int) -> "TexturesVertex":
        return TexturesVertex(_repeat(self.verts_features, n))

    def to(self, device) -> "TexturesVertex":
        return TexturesVertex(self.verts_features.to(device))

    def face_features(self, faces: torch.Tensor) -> torch.Tensor:
        """Per-face-corner features: faces (B, F, 3) -> (B, F, 3, C)."""
        return _gather_rows(self.verts_features, faces)


@dataclasses.dataclass(frozen=True)
class TexturesUV:
    """UV-mapped texture: maps (B, Hm, Wm, C) in [0, 1], verts_uvs (B, VT, 2)
    in pytorch3d's convention (u right, v up, origin at the bottom left of
    the map), faces_uvs (B, F, 3) indexing verts_uvs."""

    maps: torch.Tensor
    faces_uvs: torch.Tensor
    verts_uvs: torch.Tensor

    def extend(self, n: int) -> "TexturesUV":
        return TexturesUV(_repeat(self.maps, n), _repeat(self.faces_uvs, n),
                          _repeat(self.verts_uvs, n))

    def to(self, device) -> "TexturesUV":
        return TexturesUV(self.maps.to(device), self.faces_uvs.to(device),
                          self.verts_uvs.to(device))

    def face_uvs(self, _faces_unused: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        """Per-face-corner UVs: (B, F, 3, 2)."""
        return _gather_rows(self.verts_uvs, self.faces_uvs)

    def sample(self, uv: torch.Tensor, method: str = "auto") -> torch.Tensor:
        """Bilinear sample of the map at uv (B, ..., 2) -> (B, ..., C),
        differentiable in both ``maps`` and ``uv``.

        Every ``method`` ("auto", "gather", "matmul", "pallas"; the JAX
        package's names) computes the same function through
        ops/cuda_texsample.sample_bilinear: on a CUDA tensor its
        hand-written kernel pair, on a CPU tensor its plain PyTorch version.
        The corner and weight arithmetic is the JAX package's."""
        if method not in SAMPLE_METHODS:
            raise ValueError(f"unknown method {method!r}; expected one of "
                             f"{SAMPLE_METHODS}")
        B, Hm, Wm, C = self.maps.shape
        y0, x0, wy, wx = bilinear_corners(uv, Hm, Wm)
        flat = lambda a: a.reshape(B, -1).contiguous()  # noqa: E731
        out = sample_bilinear(self.maps, flat(y0), flat(x0), flat(wy),
                              flat(wx))
        return out.reshape(uv.shape[:-1] + (C,))


def bilinear_corners(uv: torch.Tensor, Hm: int, Wm: int):
    """Upper-left corners and weights of the bilinear taps at uv (..., 2)
    on an (Hm, Wm) map: (y0, x0) int32 and (wy, wx) float32, each of uv's
    leading shape. u and v are clipped to [0, 1]; v = 0 is the bottom row
    (pytorch3d's convention); corners stay in [0, Hm - 2] x [0, Wm - 2].
    The weights carry the gradient to uv."""
    u = uv[..., 0].clamp(0.0, 1.0)
    v = uv[..., 1].clamp(0.0, 1.0)
    x = u * (Wm - 1)
    y = (1.0 - v) * (Hm - 1)
    x0 = torch.floor(x.detach()).clamp(0, Wm - 2)
    y0 = torch.floor(y.detach()).clamp(0, Hm - 2)
    return y0.to(torch.int32), x0.to(torch.int32), y - y0, x - x0


def sphere_uv_mapping(verts) -> np.ndarray:
    """Spherical UV coordinates for a star-shaped mesh: (V, 2) float32 in
    [0, 1]; u = azimuth / 2pi, v = 0.5 + asin(y / r) / pi. Gives generated
    primitives (ops.icosphere) a TexturesUV chart; the seam at u = 0/1 is
    shared by a few faces, harmless when the map is what is fitted."""
    v = np.asarray(verts, np.float64)
    r = np.clip(np.linalg.norm(v, axis=-1), 1e-12, None)
    u = (np.arctan2(v[:, 0], v[:, 2]) / (2.0 * np.pi)) % 1.0
    w = 0.5 + np.arcsin(np.clip(v[:, 1] / r, -1.0, 1.0)) / np.pi
    return np.stack([u, w], axis=-1).astype(np.float32)

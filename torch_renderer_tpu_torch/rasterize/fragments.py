"""Fragment buffers produced by mesh rasterization (PyTorch counterpart of
``torch_renderer_tpu.rasterize.fragments``).

The JAX package's bin-local attribute slabs (``BinnedAttributes``,
``interpolate_binned``) are a TPU gather workaround and are not carried
over: shading interpolates with one indexed gather over all faces.
"""

from __future__ import annotations

import dataclasses

import torch

EMPTY_DIST = 1e10  # sentinel squared distance of empty fragment slots


@dataclasses.dataclass(frozen=True)
class Fragments:
    """Per-pixel top-K face hits, pytorch3d's Fragments.

    pix_to_face: (B, H, W, K) int64 face index into the padded face axis,
        -1 for empty slots; slots are sorted by increasing z.
    zbuf:  (B, H, W, K) camera-space z of the hit (perspective-correct), -1
        for empty slots.
    bary:  (B, H, W, K, 3) perspective-correct barycentrics (clipped to the
        simplex when blur_radius > 0), 0 for empty slots.
    dists: (B, H, W, K) signed squared pixel-to-boundary distance in raster
        units (negative inside), EMPTY_DIST for empty slots.
    """

    pix_to_face: torch.Tensor
    zbuf: torch.Tensor
    bary: torch.Tensor
    dists: torch.Tensor

    @property
    def mask(self) -> torch.Tensor:
        """(B, H, W, K) bool: the slot has a real face."""
        return self.pix_to_face >= 0

    def hard_mask(self) -> torch.Tensor:
        """(B, H, W) bool hard coverage from the nearest slot."""
        return self.pix_to_face[..., 0] >= 0

    def depth(self) -> torch.Tensor:
        """(B, H, W) nearest-hit depth with background 0 (relu of zbuf)."""
        return torch.relu(self.zbuf[..., 0])


def interpolate_face_attributes(pix_to_face: torch.Tensor, bary: torch.Tensor,
                                face_attrs: torch.Tensor) -> torch.Tensor:
    """Barycentric interpolation of per-face-corner attributes.

    pix_to_face (B, ..., K), bary (B, ..., K, 3), face_attrs (B, F, 3, C)
    -> (B, ..., K, C), zeros at empty slots. One indexed gather of the
    corners; its backward is autograd's scatter-add into face_attrs."""
    B, F, _, C = face_attrs.shape
    idx = pix_to_face.clamp_min(0).reshape(B, -1, 1)
    corners = face_attrs.reshape(B, F, 3 * C).gather(
        1, idx.expand(B, idx.shape[1], 3 * C))
    corners = corners.reshape(pix_to_face.shape + (3, C))
    out = torch.einsum("...kv,...kvc->...kc", bary, corners)
    return torch.where((pix_to_face >= 0)[..., None], out,
                       torch.zeros_like(out))

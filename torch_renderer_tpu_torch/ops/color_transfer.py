"""Nearest-neighbour vertex attribute transfer (PyTorch counterpart of
``torch_renderer_tpu.ops.color_transfer``).

The rebuild of the reference's open3d color-reattach step
(query_vertex_color_from_o3d_triMesh, deform_mesh_from_pcd.py:24-33):
after deforming a blank mesh toward a colored target, each result vertex
takes the color of its nearest target vertex. One batched query on the
tensors' device.
"""

from __future__ import annotations

from typing import Optional

import torch

from .knn_chamfer import knn_points, nn_points


def _take(colors: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """colors (B, M, C), idx (B, ...) -> (B, ..., C)."""
    B, C = colors.shape[0], colors.shape[-1]
    flat = idx.reshape(B, -1, 1).expand(B, idx[0].numel(), C)
    return colors.gather(1, flat).reshape(idx.shape + (C,))


def query_vertex_colors(query_verts: torch.Tensor, ref_verts: torch.Tensor,
                        ref_colors: torch.Tensor,
                        ref_mask: Optional[torch.Tensor] = None,
                        k: int = 1) -> torch.Tensor:
    """Per-vertex colors transferred from a reference mesh or cloud:
    query_verts (B, V, 3), ref_verts (B, M, 3), ref_colors (B, M, C)
    (unbatched 2-D inputs gain a batch of 1). k > 1 averages the k nearest
    reference colors with inverse-distance weights. Returns (B, V, C)."""
    if query_verts.ndim == 2:
        query_verts = query_verts[None]
    if ref_verts.ndim == 2:
        ref_verts = ref_verts[None]
    if ref_colors.ndim == 2:
        ref_colors = ref_colors[None]
    if k == 1:
        _, idx = nn_points(query_verts, ref_verts, y_mask=ref_mask)
        return _take(ref_colors, idx)
    d2, idx = knn_points(query_verts, ref_verts, k, y_mask=ref_mask)
    w = 1.0 / d2.clamp_min(1e-12)                    # (B, V, k)
    w = w / w.sum(-1, keepdim=True)
    return torch.einsum("bvk,bvkc->bvc", w, _take(ref_colors, idx))

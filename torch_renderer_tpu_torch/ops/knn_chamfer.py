"""Batched nearest neighbours and the chamfer distance (PyTorch counterpart
of ``torch_renderer_tpu.ops.knn_chamfer``, pytorch3d's knn_points and
chamfer_distance).

For the cloud sizes the fits use (500-2000 points) a dense (B, N, M) squared
distance matrix from one batched matrix product (|x|^2 + |y|^2 - 2 <x, y>)
followed by a masked min or top-k is the simple, fast shape. Padded points
are masked with a large distance. The product runs in full float32 (the
port never enables TF32 for matrix products).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..structures.pointclouds import Pointclouds

_BIG = 1e30


def square_distance_matrix(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances x (B, N, 3), y (B, M, 3) -> (B, N, M),
    clamped at 0 (the expansion can go slightly negative in float32)."""
    xx = (x * x).sum(-1)
    yy = (y * y).sum(-1)
    xy = torch.bmm(x, y.transpose(1, 2))
    return (xx[..., :, None] + yy[..., None, :] - 2.0 * xy).clamp_min(0.0)


def _mask_cols(d2: torch.Tensor, y_mask: Optional[torch.Tensor]):
    if y_mask is None:
        return d2
    return torch.where(y_mask[:, None, :] > 0, d2, torch.full_like(d2, _BIG))


def nn_points(x, y, x_mask=None, y_mask=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest neighbour in y of each x: (dists2 (B, N), idx (B, N)).
    Padded y points never match; padded x rows give 0 when x_mask is
    given."""
    d2 = _mask_cols(square_distance_matrix(x, y), y_mask)
    dmin, idx = d2.min(-1)
    if x_mask is not None:
        dmin = dmin * x_mask
    return dmin, idx


def knn_points(x, y, k: int, x_mask=None, y_mask=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest neighbours in y of each x: (dists2 (B, N, k)
    ascending, idx (B, N, k))."""
    d2 = _mask_cols(square_distance_matrix(x, y), y_mask)
    d, idx = torch.topk(d2, k, dim=-1, largest=False, sorted=True)
    if x_mask is not None:
        d = d * x_mask[..., None]
    return d, idx


def chamfer_distance(x, y, x_mask=None, y_mask=None,
                     batch_reduction: Optional[str] = "mean",
                     point_reduction: str = "mean",
                     single_directional: bool = False):
    """Chamfer distance with pytorch3d's semantics: point-reduced
    min_m |x_n - y_m|^2, plus the same from y to x unless
    single_directional. Returns (loss, None) as pytorch3d does; with
    batch_reduction None the loss is the per-cloud (B,) vector."""
    def one_way(a, b, a_mask, b_mask):
        d, _ = nn_points(a, b, a_mask, b_mask)
        if point_reduction != "mean":
            return d.sum(-1)
        n = a_mask.sum(-1) if a_mask is not None else \
            torch.full((a.shape[0],), float(a.shape[1]), device=a.device)
        return d.sum(-1) / n.clamp_min(1.0)

    cham = one_way(x, y, x_mask, y_mask)
    if not single_directional:
        cham = cham + one_way(y, x, y_mask, x_mask)
    if batch_reduction == "mean":
        return cham.mean(), None
    if batch_reduction == "sum":
        return cham.sum(), None
    return cham, None


def chamfer_pointclouds(a: Pointclouds, b: Pointclouds,
                        batch_reduction: Optional[str] = "mean"):
    """Chamfer distance between two Pointclouds (masks applied)."""
    return chamfer_distance(a.points, b.points, a.mask(), b.mask(),
                            batch_reduction=batch_reduction)

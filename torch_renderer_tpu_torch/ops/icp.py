"""Batched point-cloud registration: Umeyama alignment and iterative
closest point (PyTorch counterpart of ``torch_renderer_tpu.ops.icp``,
pytorch3d's iterative_closest_point).

Each ICP step is one dense nearest-neighbour query (ops/knn_chamfer, a
batched matrix product in full float32) and one Umeyama alignment, whose
batched 3x3 SVD is the hand-written kernel of ops/cuda_svd3.py on the card
(torch.linalg.svd would wait for the host every step). The loop runs
through utils/graph.StepGraph: on the card each step is a replay of one
captured CUDA graph, the port's counterpart of the JAX package's one
jitted lax.scan. The step reads the transform from, and writes it back
into, tensors that keep their addresses, writes its history at a step
counter on the device, and reads nothing back to the host.

Convention: column vectors, Xt = s * R @ x + t (OpenCV style), unlike
pytorch3d's row-vector X @ R + T. ``ICPSolution`` has pytorch3d's fields
(converged, rmse, Xt, RTs, t_history) and the JAX package's rmse_history.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..utils.graph import StepGraph
from .cuda_svd3 import det3, svd3
from .knn_chamfer import nn_points


class SimilarityTransform(NamedTuple):
    R: torch.Tensor  # (B, 3, 3)
    t: torch.Tensor  # (B, 3)
    s: torch.Tensor  # (B,)


@dataclasses.dataclass(frozen=True)
class ICPSolution:
    converged: torch.Tensor     # (B,) bool
    rmse: torch.Tensor          # (B,) the last step's RMSE
    Xt: torch.Tensor            # (B, N, 3) transformed source
    RTs: SimilarityTransform
    t_history: torch.Tensor     # (iters, B, 3) translation per step
    rmse_history: torch.Tensor  # (iters, B)


def umeyama(X: torch.Tensor, Y: torch.Tensor,
            weights: Optional[torch.Tensor] = None,
            estimate_scale: bool = False) -> SimilarityTransform:
    """Weighted least-squares rigid (or similarity) alignment of paired
    points: min sum_i w_i |s R x_i + t - y_i|^2 (Umeyama 1991). X, Y
    (B, N, 3); weights (B, N) or None."""
    B, N, _ = X.shape
    w = torch.ones((B, N), dtype=X.dtype, device=X.device) \
        if weights is None else weights
    wn = (w / w.sum(-1, keepdim=True).clamp_min(1e-12))[..., None]
    mx = (X * wn).sum(1)
    my = (Y * wn).sum(1)
    Xc = X - mx[:, None]
    Yc = Y - my[:, None]
    # cov = sum_i w_i y_i x_i^T, (B, 3, 3)
    cov = torch.bmm((Yc * wn).transpose(1, 2), Xc)
    U, S, Vt = svd3(cov)
    det = det3(U @ Vt)
    one = torch.ones_like(det)
    D = torch.stack([one, one, torch.sign(det)], dim=-1)
    R = U @ (D[..., None] * Vt)
    if estimate_scale:
        var_x = ((Xc * Xc).sum(-1) * wn[..., 0]).sum(-1)
        s = (S * D).sum(-1) / var_x.clamp_min(1e-12)
    else:
        s = torch.ones((B,), dtype=X.dtype, device=X.device)
    t = my - s[:, None] * torch.einsum("bij,bj->bi", R, mx)
    return SimilarityTransform(R=R, t=t, s=s)


def _apply(R, t, s, pts):
    return s[:, None, None] * torch.einsum("bij,bnj->bni", R, pts) \
        + t[:, None]


def iterative_closest_point(
    X: torch.Tensor, Y: torch.Tensor,
    x_mask: Optional[torch.Tensor] = None,
    y_mask: Optional[torch.Tensor] = None,
    init_transform: Optional[SimilarityTransform] = None,
    max_iterations: int = 100, relative_rmse_thr: float = 1e-6,
    estimate_scale: bool = False, capture=None,
) -> ICPSolution:
    """Batched ICP aligning X (B, N, 3) onto Y (B, M, 3).

    Runs exactly max_iterations steps, as the JAX package's scan does;
    ``converged`` says whether the relative RMSE change fell below
    relative_rmse_thr at any step (pytorch3d's criterion, without the
    early exit; the steps after convergence change nothing). capture
    (utils/graph.py): None replays one captured CUDA graph a step on the
    card and runs eagerly on the CPU; True requires the card; False runs
    eagerly."""
    B, N, _ = X.shape
    dev, dt = X.device, X.dtype
    w = torch.ones((B, N), dtype=dt, device=dev) if x_mask is None \
        else x_mask
    if init_transform is None:
        R = torch.eye(3, dtype=dt, device=dev).expand(B, 3, 3).clone()
        t = torch.zeros((B, 3), dtype=dt, device=dev)
        s = torch.ones((B,), dtype=dt, device=dev)
    else:
        R, t, s = (x.detach().to(dev).clone() for x in init_transform)
    prev = torch.full((B,), float("inf"), dtype=dt, device=dev)
    converged = torch.zeros((B,), dtype=torch.bool, device=dev)
    t_hist = torch.zeros((max_iterations, B, 3), dtype=dt, device=dev)
    rmse_hist = torch.zeros((max_iterations, B), dtype=dt, device=dev)
    k = torch.zeros((1,), dtype=torch.int64, device=dev)
    sw = w.sum(-1).clamp_min(1.0)

    def step():
        d2, idx = nn_points(_apply(R, t, s, X), Y, x_mask, y_mask)
        matched = Y.gather(1, idx[..., None].expand(B, N, 3))
        new = umeyama(X, matched, weights=w, estimate_scale=estimate_scale)
        rmse = torch.sqrt((d2 * w).sum(-1) / sw)
        rel = (prev - rmse).abs() / prev.clamp_min(1e-12)
        converged.logical_or_(rel < relative_rmse_thr)
        t_hist.index_copy_(0, k, new.t[None])
        rmse_hist.index_copy_(0, k, rmse[None])
        k.add_(1)
        R.copy_(new.R)
        t.copy_(new.t)
        s.copy_(new.s)
        prev.copy_(rmse)

    run = StepGraph(step, dev, capture)
    for _ in range(max_iterations):
        run()
    run.release()
    return ICPSolution(converged=converged, rmse=prev, Xt=_apply(R, t, s, X),
                       RTs=SimilarityTransform(R=R, t=t, s=s),
                       t_history=t_hist, rmse_history=rmse_hist)

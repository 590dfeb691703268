"""Batched point-cloud registration workload: synthetic pairs, batched ICP
and its accuracy metrics (PyTorch counterpart of
``torch_renderer_tpu.opt.registration``, the reference's
pytorch3d_icp_registeration.py).

``create_register_data`` builds N source/target pairs with known SE(3)
perturbations, an optional partial-view crop and point noise (reference
:77-152); ``register_batch`` registers all of them in one batched ICP
(reference :154-185 runs pytorch3d's CUDA ICP over 300 clouds), a
captured CUDA graph a step on the card; ``evaluate_registration`` scores
translation-L2 and quaternion-angle errors against the ground truth
(reference :299-330). ``icp_cpu_reference`` is the numpy stand-in for the
reference's open3d CPU registration, the oracle of the device path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .._device import draw
from ..ops.icp import ICPSolution, SimilarityTransform, iterative_closest_point
from ..transforms.so3 import (
    axis_angle_to_matrix,
    matrix_to_quaternion,
    quaternion_distance,
    transform_points,
)


@dataclasses.dataclass(frozen=True)
class RegisterDataConfig:
    """Perturbation scales of the reference's synthetic benchmark
    (pytorch3d_icp_registeration.py:77-152): a bounded random rotation
    angle, a Gaussian translation, an optional crop and point noise."""

    n_objects: int = 300
    translation_std: float = 0.05
    max_angle: float = 0.3        # radians, uniform axis * uniform angle
    crop_fraction: float = 0.0    # 0.5 = keep the half-space through centroid
    noise_std: float = 0.0


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(1e-12)


def create_register_data(generator: torch.Generator, base_points,
                         config: RegisterDataConfig
                         ) -> Dict[str, torch.Tensor]:
    """A batch of (source, target) pairs with known ground truth, on
    base_points' device; the draws come from ``generator`` (on its own
    device).

    base_points (P, 3): the canonical cloud. target[b] = R_gt[b] @ source
    + t_gt[b] (+ noise), R_gt a rotation about a uniform random axis by an
    angle uniform in [-max_angle, max_angle]; with crop_fraction c the
    target mask keeps the points on one side of a random plane through the
    target's centroid, above the c-quantile (partial views, reference
    :124-137). Returns source, target (B, P, 3), target_mask (B, P),
    gt_R (B, 3, 3) and gt_t (B, 3)."""
    base = torch.as_tensor(base_points, dtype=torch.float32)
    dev = base.device
    B, P = config.n_objects, base.shape[0]

    def normal(shape):
        return draw(torch.randn, generator, shape, dev)

    axis = _unit(normal((B, 3)))
    angle = (2.0 * draw(torch.rand, generator, (B, 1), dev) - 1.0) \
        * config.max_angle
    gt_R = axis_angle_to_matrix(axis * angle)
    gt_t = config.translation_std * normal((B, 3))

    source = base.expand(B, P, 3).contiguous()
    target = transform_points(gt_R, gt_t, source)
    if config.noise_std > 0:
        target = target + config.noise_std * normal(target.shape)
    if config.crop_fraction > 0:
        plane = _unit(normal((B, 3)))
        centroid = target.mean(1, keepdim=True)
        side = torch.einsum("bpc,bc->bp", target - centroid, plane)
        thresh = torch.quantile(side, config.crop_fraction, dim=-1,
                                keepdim=True)
        target_mask = (side >= thresh).to(torch.float32)
    else:
        target_mask = torch.ones((B, P), dtype=torch.float32, device=dev)
    return {"source": source, "target": target, "target_mask": target_mask,
            "gt_R": gt_R, "gt_t": gt_t}


def register_batch(data: Dict[str, torch.Tensor], max_iterations: int = 100,
                   init_transform: Optional[SimilarityTransform] = None,
                   capture=None) -> ICPSolution:
    """One batched ICP over every pair (reference ICP_on_GPU, :154-185,
    with no per-object host work); capture as iterative_closest_point."""
    return iterative_closest_point(
        data["source"], data["target"], y_mask=data["target_mask"],
        init_transform=init_transform, max_iterations=max_iterations,
        capture=capture)


def register_batch_sharded(data: Dict[str, torch.Tensor], device_mesh,
                           max_iterations: int = 100,
                           init_transform: Optional[SimilarityTransform]
                           = None, capture=None) -> ICPSolution:
    """The object axis split over the mesh's 'data' axis: every rank passes
    the whole batch, registers its slice (padded to a multiple of the axis
    size by repeating the last object, init_transform alike) with no
    collective inside the loop (each ICP step is per object: nearest
    neighbours and a Umeyama SVD, svd3 on the card), so the loop runs
    captured per rank as register_batch's does. One all_gather after it
    gives every rank the whole solution, padding cut off."""
    from ..parallel.mesh import (
        DATA_AXIS,
        all_gather_batch,
        axis_size,
        check_mesh,
        shard_batch,
    )

    check_mesh(device_mesh)
    d = axis_size(device_mesh, DATA_AXIS)
    B = data["source"].shape[0]
    Bp = -(-B // d) * d

    def pad(x):
        return torch.cat([x, x[-1:].expand((Bp - B,) + x.shape[1:])]) \
            if Bp > B else x

    local = shard_batch(
        {k: pad(data[k]) for k in ("source", "target", "target_mask")},
        device_mesh)
    init = None if init_transform is None else shard_batch(
        SimilarityTransform(*(pad(x) for x in init_transform)), device_mesh)
    sol = register_batch(local, max_iterations, init, capture=capture)
    # the histories are (iterations, batch, ...): gather them on dim 1
    t_hist, rmse_hist = (all_gather_batch(x.movedim(1, 0), device_mesh)
                         .movedim(0, 1)[:, :B]
                         for x in (sol.t_history, sol.rmse_history))
    whole = all_gather_batch(
        (sol.converged, sol.rmse, sol.Xt, sol.RTs), device_mesh)
    converged, rmse, Xt, RTs = (
        x[:B] if isinstance(x, torch.Tensor)
        else SimilarityTransform(*(y[:B] for y in x)) for x in whole)
    return ICPSolution(converged=converged, rmse=rmse, Xt=Xt, RTs=RTs,
                       t_history=t_hist, rmse_history=rmse_hist)


def evaluate_registration(sol: ICPSolution, gt_R: torch.Tensor,
                          gt_t: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Translation-L2 (m) and rotation-angle (rad) errors per object, the
    reference's accuracy scatter metrics (:299-330)."""
    trans_err = torch.linalg.norm(sol.RTs.t - gt_t, dim=-1)
    rot_err = quaternion_distance(matrix_to_quaternion(sol.RTs.R),
                                  matrix_to_quaternion(gt_R))
    return {"trans_err": trans_err, "rot_err": rot_err, "rmse": sol.rmse,
            "converged": sol.converged, "mean_trans_err": trans_err.mean(),
            "mean_rot_err": rot_err.mean()}


def icp_cpu_reference(source, target, max_iterations: int = 100):
    """Pure-numpy single-cloud ICP, the CPU oracle standing in for the
    reference's open3d registration_icp baseline (:191-238). Returns
    (R (3, 3), t (3,), rmse)."""
    import numpy as np

    X = np.asarray(source, np.float64)
    Y = np.asarray(target, np.float64)
    R = np.eye(3)
    t = np.zeros(3)
    prev = np.inf
    for _ in range(max_iterations):
        Xt = X @ R.T + t
        d2 = ((Xt[:, None, :] - Y[None, :, :]) ** 2).sum(-1)
        idx = d2.argmin(axis=1)
        matched = Y[idx]
        rmse = float(np.sqrt(d2.min(axis=1).mean()))
        mx, my = X.mean(0), matched.mean(0)
        cov = (matched - my).T @ (X - mx)
        U, _, Vt = np.linalg.svd(cov)
        D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
        R = U @ D @ Vt
        t = my - R @ mx
        if abs(prev - rmse) < 1e-9:
            break
        prev = rmse
    return R, t, prev

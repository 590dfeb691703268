"""Camera pose optimization by analysis-by-synthesis (PyTorch counterpart of
``torch_renderer_tpu.opt.pose_fit``).

A 7-DoF camera (translation + quaternion) is fitted to reference depth,
silhouette and RGB images with silhouette L1 + masked depth Huber + RGB MSE
and Adam. One rasterization per step feeds every loss term.

The fit is a loop over ``torch.optim.Adam``, whose defaults (betas
0.9/0.999, eps 1e-8 added outside the square root) equal optax.adam's; on
the card each iteration is a replay of a captured CUDA graph (the JAX
package's jitted lax.scan). The per-step metrics stay on the device;
nothing in the loop reads a value back to the host ("warn" budget checks
report after it), so the step never waits for the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..renderer import MeshRenderer
from ..rasterize.binning import deferred_budget_checks
from ..structures.meshes import Meshes
from ..transforms.so3 import (
    matrix_to_quaternion,
    quaternion_multiply,
    quaternion_normalize,
    quaternion_to_matrix,
)
from ..utils.graph import StepGraph
from .history import MetricHistory


def huber_loss(pred: torch.Tensor, target: torch.Tensor,
               delta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber (SmoothL1 for delta=1)."""
    abs_err = (pred - target).abs()
    quad = abs_err.clamp_max(delta)
    return 0.5 * quad * quad + delta * (abs_err - quad)


def iou(pred_mask: torch.Tensor, gt_mask: torch.Tensor,
        eps: float = 1e-8) -> torch.Tensor:
    """Soft IoU over the trailing (H, W) dims."""
    inter = (pred_mask * gt_mask).sum((-2, -1))
    union = (pred_mask + gt_mask - pred_mask * gt_mask).sum((-2, -1))
    return inter / (union + eps)


def patch_occlusion(generator: torch.Generator, image: torch.Tensor,
                    patch_size: int = 50, n_patches: int = 1,
                    fill: float = 0.0) -> torch.Tensor:
    """Fill random square patches of a (B, H, W) image. The patch corners
    come from ``generator`` (a CPU generator, so a seed gives the same
    patches on every device)."""
    B, H, W = image.shape
    yy = torch.arange(H, device=image.device)[None, :, None]
    xx = torch.arange(W, device=image.device)[None, None, :]
    for _ in range(n_patches):
        y0 = torch.randint(0, max(H - patch_size, 1), (B,),
                           generator=generator).to(image.device)
        x0 = torch.randint(0, max(W - patch_size, 1), (B,),
                           generator=generator).to(image.device)
        y0, x0 = y0[:, None, None], x0[:, None, None]
        inside = ((yy >= y0) & (yy < y0 + patch_size)
                  & (xx >= x0) & (xx < x0 + patch_size))
        image = torch.where(inside, fill, image)
    return image


@dataclasses.dataclass(frozen=True)
class PoseFitConfig:
    """Loss weights and optimizer settings."""

    lr: float = 1e-3
    n_steps: int = 500
    w_sil: float = 1.0
    w_depth: float = 1.0
    w_rgb: float = 0.01
    w_quat_norm: float = 1.0   # keeps the quaternion near unit norm
    huber_delta: float = 1.0
    use_rgb: bool = True


def pose_params_from_Rt(R, t, device=None) -> Dict[str, torch.Tensor]:
    """7-DoF parameters {t: (B, 3), quat: (B, 4)} from OpenCV (R, t), on
    ``device`` (default: R's device when R is a tensor, else the card)."""
    device = resolve_device(device, like=R)

    def tensor(x):
        if not isinstance(x, torch.Tensor):
            x = np.array(x, dtype=np.float32)
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    R, t = tensor(R), tensor(t)
    if R.ndim == 2:
        R = R[None]
    if t.ndim == 1:
        t = t[None]
    return {"t": t, "quat": matrix_to_quaternion(R)}


def pose_params_to_Rt(params: Dict[str, torch.Tensor]):
    return quaternion_to_matrix(quaternion_normalize(params["quat"])), \
        params["t"]


class CameraPoseFitter:
    """Analysis-by-synthesis camera pose fit: one MeshRenderer
    rasterization per step gives depth, the silhouette and soft-Phong RGB.

    silhouette_impl="fragments" (default) blends K fragments
    (faces_per_pixel, blur log(1/1e-4 - 1) * sigma) into the silhouette;
    "pallas" renders the exact all-faces soft silhouette with the soft
    coverage kernels (rasterize/cuda_soft.py) and K=1 hard fragments at
    blur 0 for depth and RGB. The name is the JAX package's. faces_per_tile,
    sil_active_tiles, sil_layout, sil_group_lanes or one sil_config
    (cuda_soft.SoftKernelConfig) size that silhouette. renderer_kw go to
    MeshRenderer (device= among them).
    """

    def __init__(self, K, image_size: Tuple[int, int],
                 config: PoseFitConfig = PoseFitConfig(),
                 faces_per_pixel: int = 4, sigma: float = 1e-4,
                 blur_radius: Optional[float] = None,
                 silhouette_impl: str = "fragments",
                 faces_per_tile: int = 128,
                 sil_active_tiles: Optional[int] = None,
                 sil_layout: str = "lane",
                 sil_group_lanes: Optional[int] = None, sil_config=None,
                 **renderer_kw):
        if silhouette_impl not in ("fragments", "pallas"):
            raise ValueError(f"unknown silhouette_impl {silhouette_impl!r}")
        self.silhouette_impl = silhouette_impl
        self.sigma = sigma
        self.sil_hi_tiles = None
        self.sil_lo_lanes = 32
        if sil_config is not None:
            faces_per_tile = sil_config.faces_per_tile
            sil_active_tiles = sil_config.active_tiles
            sil_layout = sil_config.layout
            sil_group_lanes = sil_config.group_lanes
            self.sil_hi_tiles = sil_config.hi_tiles
            self.sil_lo_lanes = sil_config.lo_lanes
        self.faces_per_tile = faces_per_tile
        self.sil_active_tiles = sil_active_tiles
        self.sil_layout = sil_layout
        self.sil_group_lanes = sil_group_lanes
        if silhouette_impl == "pallas":
            blur_radius = 0.0
            faces_per_pixel = min(faces_per_pixel, 1)
        elif blur_radius is None:
            blur_radius = math.log(1.0 / 1e-4 - 1.0) * sigma
        self.config = config
        self.renderer = MeshRenderer(
            K, image_size, blur_radius=blur_radius,
            faces_per_pixel=faces_per_pixel, sigma=sigma, **renderer_kw)

    @property
    def device(self) -> torch.device:
        return self.renderer.device

    # -- rendering ----------------------------------------------------------
    def render(self, meshes: Meshes, params: Dict[str, torch.Tensor]):
        R, t = pose_params_to_Rt(params)
        if self.silhouette_impl == "pallas":
            from ..rasterize.cuda_soft import soft_silhouette_cuda

            out = self.renderer.render(meshes, R, t, with_silhouette=False,
                                       with_rgb=self.config.use_rgb)
            sil = soft_silhouette_cuda(
                meshes, self.renderer.camera_with_pose(R, t),
                sigma=self.sigma, faces_per_tile=self.faces_per_tile,
                active_tiles=self.sil_active_tiles, layout=self.sil_layout,
                group_lanes=self.sil_group_lanes,
                hi_tiles=self.sil_hi_tiles, lo_lanes=self.sil_lo_lanes)
            return dataclasses.replace(out, silhouette=sil)
        return self.renderer.render(meshes, R, t, with_silhouette=True,
                                    with_rgb=self.config.use_rgb)

    @torch.no_grad()
    def make_references(self, meshes: Meshes, R_gt, t_gt,
                        occlusion_generator: Optional[torch.Generator] = None,
                        patch_size: int = 50) -> Dict[str, torch.Tensor]:
        """Reference images at the true pose, through the same render path
        as the fit (so the loss is zero there), with an optional patch
        occlusion of the depth."""
        out = self.render(meshes, pose_params_from_Rt(R_gt, t_gt,
                                                      self.device))
        depth = out.depth
        if occlusion_generator is not None:
            depth = patch_occlusion(occlusion_generator, depth, patch_size)
        refs = {"depth": depth, "sil": out.silhouette,
                "mask": (depth > 0).to(torch.float32)}
        if self.config.use_rgb:
            refs["rgb"] = out.rgb
        return refs

    # -- loss ---------------------------------------------------------------
    def loss(self, params, meshes: Meshes, refs, totals=None):
        """(total loss, metrics dict of 0-dim tensors).

        totals: {"batch": B, "npix": mask count} of a whole batch of which
        meshes, refs and params are one slice (parallel.sharded.
        data_parallel_fit): every mean is then the slice's sum over the
        whole batch's size, so the slices' losses and metrics add up to the
        whole batch's."""
        cfg = self.config
        out = self.render(meshes, params)
        m = refs["mask"]
        if totals is None:
            def mean(x):
                return x.mean()

            npix = m.sum().clamp_min(1.0)
        else:
            def mean(x):
                return x.sum() / (x.numel() // x.shape[0] * totals["batch"])

            npix = totals["npix"]
        sil_l1 = mean((out.silhouette - refs["sil"]).abs())
        depth_h = (huber_loss(out.depth, refs["depth"], cfg.huber_delta)
                   * m).sum() / npix
        total = cfg.w_sil * sil_l1 + cfg.w_depth * depth_h
        metrics = {"loss_sil": sil_l1, "loss_depth": depth_h}
        if cfg.use_rgb and "rgb" in refs:
            rgb_mse = mean((out.rgb - refs["rgb"]) ** 2)
            total = total + cfg.w_rgb * rgb_mse
            metrics["loss_rgb"] = rgb_mse
        qn = torch.linalg.norm(params["quat"], dim=-1)
        total = total + cfg.w_quat_norm * mean((qn - 1.0) ** 2)
        metrics["loss"] = total
        metrics["quat_norm"] = mean(qn)
        metrics["iou"] = mean(iou((out.silhouette > 0.5).to(torch.float32),
                                  refs["mask"]))
        return total, metrics

    # -- optimization -------------------------------------------------------
    def prepare(self, meshes: Meshes, params0) -> None:
        """Resolve auto raster settings from the start pose with a 2x
        margin (the footprint moves as the pose converges), widening any
        earlier resolution, e.g. the one made rendering the references."""
        if self.renderer.settings.bin_size is None:
            R0, t0 = pose_params_to_Rt(params0)
            self.renderer.prepare(meshes, R0.detach(), t0.detach(),
                                  grow=True, margin=2.0)

    def fit(self, meshes: Meshes, refs, params0: Dict[str, torch.Tensor],
            n_steps: Optional[int] = None, capture=None, totals=None):
        """Run the Adam loop. Returns (final params, metrics history dict
        of (n_steps,) tensors on the device); each step's metrics are those
        of the parameters before its update.

        capture (utils/graph.py): None runs each iteration as a replay of
        one captured CUDA graph on the card (the JAX package's one jitted
        lax.scan) and eagerly on the CPU; True requires the card; False
        runs it eagerly. On the card Adam is capturable (its step count on
        the device) on either route, so both run the same arithmetic. The
        parameters are updated in place; "warn" budget checks report once,
        after the loop (binning.deferred_budget_checks). totals: as in
        loss(), for a fit of one slice of a batch."""
        cfg = self.config
        n = int(n_steps if n_steps is not None else cfg.n_steps)
        params = {k: v.detach().clone().to(self.device).requires_grad_(True)
                  for k, v in params0.items()}
        self.prepare(meshes, params)
        opt = torch.optim.Adam(list(params.values()), lr=cfg.lr,
                               capturable=self.device.type == "cuda")
        history = MetricHistory(n, self.device)

        def iteration():
            opt.zero_grad(set_to_none=True)
            total, metrics = self.loss(params, meshes, refs, totals)
            total.backward()
            opt.step()
            history.add(metrics)

        step = StepGraph(iteration, self.device, capture)
        with deferred_budget_checks():
            for _ in range(n):
                step()
        step.release()
        return {k: v.detach() for k, v in params.items()}, history.result()


class DepthPoseFitter(CameraPoseFitter):
    """Depth + silhouette only (no RGB term)."""

    def __init__(self, K, image_size, config: Optional[PoseFitConfig] = None,
                 **kw):
        cfg = config or PoseFitConfig(use_rgb=False, w_rgb=0.0)
        if cfg.use_rgb:
            cfg = dataclasses.replace(cfg, use_rgb=False, w_rgb=0.0)
        super().__init__(K, image_size, cfg, **kw)

    @staticmethod
    def references_from_recorded(depth, device=None) -> Dict[str,
                                                              torch.Tensor]:
        """References from a recorded depth image (B, H, W) or (H, W), on
        ``device`` (default: depth's device when it is a tensor, else the
        card)."""
        device = resolve_device(device, like=depth)
        depth = torch.as_tensor(np.array(depth, dtype=np.float32)
                                if not isinstance(depth, torch.Tensor)
                                else depth, dtype=torch.float32,
                                device=device)
        if depth.ndim == 2:
            depth = depth[None]
        mask = (depth > 0).to(torch.float32)
        return {"depth": depth, "sil": mask, "mask": mask}


class ObjectPoseFitter(DepthPoseFitter):
    """One trainable object pose O (object -> world) seen through FIXED
    per-frame camera extrinsics (F, 4, 4): frame f renders at
    (R_f R_o, R_f t_o + t_f). Params {t: (1, 3), quat: (1, 4)}; pass
    meshes.extend(F) and the stacked recorded depths."""

    def __init__(self, K, image_size, extrinsics, config=None, **kw):
        super().__init__(K, image_size, config, **kw)
        ext = np.asarray(extrinsics, np.float32)
        if ext.ndim == 2:
            ext = ext[None]
        self.cam_R = torch.as_tensor(ext[:, :3, :3].copy(), device=self.device)
        self.cam_t = torch.as_tensor(ext[:, :3, 3].copy(), device=self.device)
        self.cam_quat = matrix_to_quaternion(self.cam_R)
        self.n_frames = int(ext.shape[0])

    def compose(self, params):
        """Per-frame camera params from the object pose; the product with
        the unit cam_quat keeps |q_o|, so the quaternion-norm term acts the
        same through the chain."""
        q_o = quaternion_normalize(params["quat"][0])
        q = quaternion_multiply(self.cam_quat, q_o[None, :])
        t = torch.einsum("fij,j->fi", self.cam_R, params["t"][0]) + self.cam_t
        return {"quat": q, "t": t}

    def render(self, meshes: Meshes, params):
        return super().render(meshes, self.compose(params))

    def prepare(self, meshes: Meshes, params0) -> None:
        super().prepare(meshes, self.compose(params0))

    def object_pose(self, params) -> torch.Tensor:
        """(4, 4) fitted object pose (object -> world)."""
        M = torch.eye(4, dtype=torch.float32, device=params["t"].device)
        M[:3, :3] = quaternion_to_matrix(quaternion_normalize(
            params["quat"]))[0]
        M[:3, 3] = params["t"][0]
        return M

    @staticmethod
    def params_from_object_pose(object_mat, device=None):
        """Initial params from a (4, 4) object pose matrix."""
        M = np.asarray(object_mat, np.float32)
        return pose_params_from_Rt(M[:3, :3], M[:3, 3], device)

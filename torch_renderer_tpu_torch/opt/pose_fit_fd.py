"""Finite-difference pose fitting: a depth pose fit without autodiff
(PyTorch counterpart of ``torch_renderer_tpu.opt.pose_fit_fd``, the
reference's myrenderer.py).

The gradient over a 6-DoF [axis-angle, translation] parameter is estimated
by central differences of +/- eps on each axis (estimate_gradient,
reference :152-164), followed by a normalized-gradient step that is kept
only if it lowers the loss (reference :200-205). The loss (depth L1 on the
overlap plus the coverage mismatch, :128-150) has boolean masks, hence the
differences.

The 2D = 12 perturbed poses render as ONE batched K=1 depth call (the JAX
package vmaps them; the reference loops), and the candidate and current
pose as a second call of two, whose losses give the step's history too.
On the card both calls run the binned raster's kernels (hard_k1, the tile
gather and the untile epilogue): two launches of each a step. The loop runs
through utils/graph.StepGraph, a replay of one captured CUDA graph a step
on the card (the JAX package's jitted lax.scan); it updates the parameters
in place and keeps its history on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from .._device import resolve_device
from ..rasterize.binning import deferred_budget_checks
from ..rasterize.raster import rasterize_meshes
from ..renderer import MeshRenderer
from ..structures.meshes import Meshes
from ..transforms.so3 import axis_angle_to_matrix
from ..utils.graph import StepGraph
from .history import MetricHistory


def _fd_rows(params: torch.Tensor, eps: float) -> torch.Tensor:
    """(2D, D): params + eps e_i for each axis i, then params - eps e_i."""
    eye = torch.eye(params.shape[0], dtype=params.dtype,
                    device=params.device) * eps
    return torch.cat([params[None] + eye, params[None] - eye], dim=0)


def _fd_combine(losses: torch.Tensor, eps: float) -> torch.Tensor:
    D = losses.shape[0] // 2
    return (losses[:D] - losses[D:]) / (2.0 * eps)


def finite_difference_grad(loss_fn: Callable[[torch.Tensor], torch.Tensor],
                           params: torch.Tensor, eps: float) -> torch.Tensor:
    """Central-difference gradient of a scalar loss over a flat (D,)
    parameter, loss_fn evaluated on the 2D perturbed rows at once through
    torch.func.vmap."""
    losses = torch.func.vmap(loss_fn)(_fd_rows(params, eps))
    return _fd_combine(losses, eps)


@dataclasses.dataclass(frozen=True)
class FDPoseFitConfig:
    """The reference's settings: eps of the central differences, the
    normalized-gradient step (myrenderer.py:152-164,200-205) and the loss
    mix of depth L1 and overlap."""

    eps: float = 1e-3
    step_size: float = 3e-2
    n_steps: int = 100
    w_depth: float = 1.0
    w_overlap: float = 1.0


class FiniteDifferencePoseFitter:
    """6-DoF (axis-angle, translation) depth pose fit of one mesh without
    autodiff. renderer_kw go to MeshRenderer (device= among them)."""

    def __init__(self, K, image_size: Tuple[int, int],
                 config: FDPoseFitConfig = FDPoseFitConfig(),
                 **renderer_kw):
        self.config = config
        self.renderer = MeshRenderer(K, image_size, faces_per_pixel=1,
                                     **renderer_kw)

    @property
    def device(self) -> torch.device:
        return self.renderer.device

    @staticmethod
    def pack(R_axis_angle, t, device=None) -> torch.Tensor:
        """The 6-DoF parameter [axis_angle (3), t (3)] (myrenderer.py:93-102)
        on ``device`` (default: R_axis_angle's device when a tensor, else
        the card)."""
        device = resolve_device(device, like=R_axis_angle)

        def vec(x):
            return torch.as_tensor(x, dtype=torch.float32,
                                   device=device).reshape(3)

        return torch.cat([vec(R_axis_angle), vec(t)])

    @staticmethod
    def unpack(params: torch.Tensor):
        """(..., 6) -> R (..., 3, 3), t (..., 3)."""
        return axis_angle_to_matrix(params[..., :3]), params[..., 3:]

    def _depths(self, meshes: Meshes, params: torch.Tensor) -> torch.Tensor:
        """Depth (n, H, W) of the one mesh at each of params (n, 6), one
        rasterization. Auto settings resolve for one view (the JAX
        package's vmapped render is one view) at params[0] unless already
        cached (fit resolves them at the start pose)."""
        n = params.shape[0]
        R, t = self.unpack(params)
        settings = self.renderer.resolved_settings(meshes, R[:1], t[:1])
        frags = rasterize_meshes(meshes.extend(n),
                                 self.renderer.camera_with_pose(R, t),
                                 settings)
        return frags.depth()

    def render_depth(self, meshes: Meshes, params: torch.Tensor
                     ) -> torch.Tensor:
        """Depth (H, W) at params (6,), or (n, H, W) at params (n, 6)."""
        if params.ndim == 1:
            return self._depths(meshes, params[None])[0]
        return self._depths(meshes, params)

    def _loss_of(self, depth: torch.Tensor, ref_depth: torch.Tensor):
        cfg = self.config
        ref_mask = ref_depth > 0
        mask = depth > 0
        overlap = ref_mask & mask
        n_overlap = overlap.sum((-2, -1))
        depth_l1 = ((depth - ref_depth).abs() * overlap).sum((-2, -1)) \
            / n_overlap.clamp_min(1)
        union = (ref_mask | mask).sum((-2, -1))
        mismatch = 1.0 - n_overlap / union.clamp_min(1)
        return cfg.w_depth * depth_l1 + cfg.w_overlap * mismatch

    def loss(self, params: torch.Tensor, meshes: Meshes,
             ref_depth: torch.Tensor) -> torch.Tensor:
        """Depth L1 on the overlap plus the coverage mismatch (the
        myrenderer forward recipe, :128-150): a scalar at params (6,), (n,)
        at params (n, 6)."""
        return self._loss_of(self.render_depth(meshes, params), ref_depth)

    def prepare(self, meshes: Meshes, params0: torch.Tensor) -> None:
        """Resolve auto raster settings from the start pose with a 2x
        margin, widening any earlier resolution (the JAX package's fit,
        :116-125)."""
        if self.renderer.settings.bin_size is None:
            R0, t0 = self.unpack(params0.detach()[None])
            self.renderer.prepare(meshes, R0, t0, grow=True, margin=2.0)

    def fit(self, meshes: Meshes, ref_depth: torch.Tensor,
            params0: torch.Tensor, n_steps: Optional[int] = None,
            capture=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Normalized-gradient descent with central-difference gradients,
        a step kept only where it lowers the loss. Returns (params,
        history {loss, grad_norm} of (n_steps,) tensors on the device);
        each step's loss is that of the parameters after it.

        capture (utils/graph.py): None replays one captured CUDA graph a
        step on the card and runs eagerly on the CPU; True requires the
        card; False runs eagerly. "warn" budget checks report once, after
        the loop."""
        cfg = self.config
        n = int(n_steps if n_steps is not None else cfg.n_steps)
        params = params0.detach().to(self.device, torch.float32).clone()
        ref_depth = ref_depth.to(self.device)
        self.prepare(meshes, params)
        history = MetricHistory(n, self.device)

        def step():
            g = _fd_combine(self.loss(_fd_rows(params, cfg.eps), meshes,
                                      ref_depth), cfg.eps)
            gn = torch.linalg.norm(g)
            size = torch.where(gn > 1e-12, cfg.step_size / gn, 0.0)
            new = params - size * g
            pair = self.loss(torch.stack([new, params]), meshes, ref_depth)
            better = pair[0] < pair[1]
            params.copy_(torch.where(better, new, params))
            history.add({"loss": torch.where(better, pair[0], pair[1]),
                         "grad_norm": gn})

        run = StepGraph(step, self.device, capture)
        with deferred_budget_checks():
            for _ in range(n):
                run()
        run.release()
        return params, history.result()

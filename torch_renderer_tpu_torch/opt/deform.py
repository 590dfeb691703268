"""Mesh deformation workloads: shape from chamfer and vertex-color fitting
(PyTorch counterpart of ``torch_renderer_tpu.opt.deform``).

  * MeshDeformer (the reference's deform_mesh_from_pcd.py): offsets of the
    source mesh's vertices, fitted to a target by the chamfer distance
    between freshly sampled surface points, plus edge, normal-consistency
    and uniform-Laplacian regularizers; SGD with momentum.
  * VertexColorFitter (the reference's mesh_deformer.py color_train):
    per-vertex RGB fitted to rendered reference views with the geometry
    frozen, plus a penalty on colors outside [0, 1]; SGD with momentum.

Both fits are Python loops whose metrics stay on the device, stacked, so no
step reads a value back to the host. torch.optim.SGD with momentum equals
optax.sgd(momentum=...): the trace starts at the first gradient and the
update is -lr times it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..ops.knn_chamfer import chamfer_distance
from ..ops.mesh_losses import (
    MeshTopology,
    build_topology,
    mesh_edge_loss,
    mesh_laplacian_smoothing,
    mesh_normal_consistency,
)
from ..ops.sample_points import sample_points_from_meshes
from ..renderer import MeshRenderer
from ..structures.meshes import Meshes
from ..structures.textures import TexturesVertex
from .history import MetricHistory


@dataclasses.dataclass(frozen=True)
class DeformConfig:
    """The reference's defaults (deform_mesh_from_pcd.py:136-149)."""

    n_samples: int = 1000
    w_chamfer: float = 1.0
    w_edge: float = 1.0
    w_normal: float = 0.01
    w_laplacian: float = 0.1
    lr: float = 1.0
    momentum: float = 0.9
    n_steps: int = 4000


class MeshDeformer:
    """Chamfer-driven vertex offset optimization. The target is a fixed
    point cloud (B, M, 3) with an optional (B, M) mask, or a Meshes that is
    re-sampled every step (as the reference samples both meshes per step).
    Everything follows the source mesh's device."""

    def __init__(self, src_meshes: Meshes,
                 target_points: Optional[torch.Tensor] = None,
                 target_meshes: Optional[Meshes] = None,
                 target_mask: Optional[torch.Tensor] = None,
                 config: DeformConfig = DeformConfig()):
        if (target_points is None) == (target_meshes is None):
            raise ValueError("provide exactly one of target_points / "
                             "target_meshes")
        self.src = src_meshes
        self.topo: MeshTopology = build_topology(src_meshes)
        self.target_points = target_points
        self.target_meshes = target_meshes
        self.target_mask = target_mask
        self.config = config

    def init_params(self) -> torch.Tensor:
        """The vertex offsets, zero."""
        return torch.zeros_like(self.src.verts)

    def loss(self, deform_verts: torch.Tensor,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.config
        new_mesh = self.src.offset_verts(deform_verts)
        sample_src = sample_points_from_meshes(new_mesh, cfg.n_samples,
                                               generator)
        if self.target_meshes is not None:
            sample_trg = sample_points_from_meshes(self.target_meshes,
                                                   cfg.n_samples, generator)
            trg_mask = None
        else:
            sample_trg, trg_mask = self.target_points, self.target_mask
        cham, _ = chamfer_distance(sample_src, sample_trg, y_mask=trg_mask)
        edge = mesh_edge_loss(new_mesh, self.topo)
        normal = mesh_normal_consistency(new_mesh, self.topo)
        lap = mesh_laplacian_smoothing(new_mesh, self.topo)
        total = (cfg.w_chamfer * cham + cfg.w_edge * edge
                 + cfg.w_normal * normal + cfg.w_laplacian * lap)
        return total, {"loss": total, "chamfer": cham, "edge": edge,
                       "normal": normal, "laplacian": lap}

    def fit(self, generator: Optional[torch.Generator] = None,
            n_steps: Optional[int] = None, snapshot_every: int = 0):
        """Run the deformation; returns (final mesh, deform_verts, history,
        snapshots). generator (on the source mesh's device) draws the
        surface samples; snapshot_every > 0 records the mesh after every
        that many steps but the last."""
        cfg = self.config
        n = int(n_steps if n_steps is not None else cfg.n_steps)
        deform = self.init_params().requires_grad_(True)
        opt = torch.optim.SGD([deform], lr=cfg.lr, momentum=cfg.momentum)
        snapshots: List[Meshes] = []
        history = MetricHistory()
        for i in range(n):
            opt.zero_grad(set_to_none=True)
            total, metrics = self.loss(deform, generator)
            total.backward()
            opt.step()
            history.add(metrics)
            if snapshot_every > 0 and (i + 1) % snapshot_every == 0 \
                    and i + 1 < n:
                snapshots.append(self.src.offset_verts(deform.detach()))
        deform = deform.detach()
        return (self.src.offset_verts(deform), deform, history.result(),
                snapshots)


@dataclasses.dataclass(frozen=True)
class ColorFitConfig:
    """The reference's defaults (mesh_deformer.py:172-207)."""

    lr: float = 1.0
    momentum: float = 0.9
    n_steps: int = 500
    w_rgb: float = 1.0
    w_clamp: float = 1.0


class VertexColorFitter:
    """Fit per-vertex RGB against rendered reference views with the
    geometry frozen; renderer_kw (device= among them) go to MeshRenderer."""

    def __init__(self, K, image_size: Tuple[int, int],
                 config: ColorFitConfig = ColorFitConfig(),
                 faces_per_pixel: int = 4, **renderer_kw):
        self.config = config
        self.renderer = MeshRenderer(K, image_size,
                                     faces_per_pixel=faces_per_pixel,
                                     **renderer_kw)

    @staticmethod
    def _views_batch(meshes: Meshes, n_views: int) -> Meshes:
        if meshes.batch_size == n_views:
            return meshes
        if meshes.batch_size != 1:
            raise ValueError("meshes batch must be 1 or n_views")
        return meshes.extend(n_views)

    @torch.no_grad()
    def make_reference_views(self, meshes_gt: Meshes, Rs, ts
                             ) -> torch.Tensor:
        """Ground-truth RGB (N, H, W, 3) from N camera poses."""
        n = len(Rs)
        return self.renderer.render(self._views_batch(meshes_gt, n), Rs, ts,
                                    with_silhouette=False, with_rgb=True).rgb

    def loss(self, verts_rgb: torch.Tensor, meshes: Meshes, Rs, ts, refs):
        cfg = self.config
        n = refs.shape[0]
        tex = TexturesVertex(verts_rgb[None].expand((n,) + verts_rgb.shape))
        textured = dataclasses.replace(self._views_batch(meshes, n),
                                       textures=tex)
        out = self.renderer.render(textured, Rs, ts, with_silhouette=False,
                                   with_rgb=True)
        rgb_mse = ((out.rgb - refs) ** 2).mean()
        clamp = (torch.relu(verts_rgb - 1.0) + torch.relu(-verts_rgb)).mean()
        total = cfg.w_rgb * rgb_mse + cfg.w_clamp * clamp
        return total, {"loss": total, "rgb_mse": rgb_mse, "clamp": clamp}

    def fit(self, meshes: Meshes, Rs, ts, refs,
            verts_rgb0: Optional[torch.Tensor] = None,
            n_steps: Optional[int] = None):
        """Returns (verts_rgb (V, 3), history of (n_steps,) tensors)."""
        cfg = self.config
        n = int(n_steps if n_steps is not None else cfg.n_steps)
        if verts_rgb0 is None:
            verts_rgb0 = torch.full(meshes.verts.shape[-2:], 0.5,
                                    device=meshes.device)
        if self.renderer.settings.bin_size is None:
            self.renderer.prepare(self._views_batch(meshes, refs.shape[0]),
                                  Rs, ts)
        rgb = verts_rgb0.detach().clone().requires_grad_(True)
        opt = torch.optim.SGD([rgb], lr=cfg.lr, momentum=cfg.momentum)
        history = MetricHistory()
        for _ in range(n):
            opt.zero_grad(set_to_none=True)
            total, metrics = self.loss(rgb, meshes, Rs, ts, refs)
            total.backward()
            opt.step()
            history.add(metrics)
        return rgb.detach(), history.result()

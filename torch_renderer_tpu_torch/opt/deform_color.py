"""Joint shape + UV-texture optimization from multi-view renders (PyTorch
counterpart of ``torch_renderer_tpu.opt.deform_color``, the reference's
deform_mesh_with_color.py).

Render an N-view RGB / silhouette dataset of a target mesh in one batched
render, then fit per-vertex offsets and a full TexturesUV map together: two
Adam parameter groups with staircase learning-rate decay, silhouette + RGB
MSE over a few random views per step, the mesh shape priors and a clamp
penalty that keeps the texture in [0, 1].

Each step renders views_per_step views through the top-K raster kernel,
shades them with the texture-sampling kernel pair and steps Adam; on the
card each step is a replay of a captured CUDA graph. The view subsets are
drawn from a torch.Generator before the loop and moved to the device once;
the step picks its row, and its learning rates, by a step counter on the
device, and the metrics stay on the device, so nothing in the loop reads a
value back to the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..cameras.look_at import look_at_view_transform
from ..ops.mesh_losses import (
    build_topology,
    mesh_edge_loss,
    mesh_laplacian_smoothing,
    mesh_normal_consistency,
)
from ..rasterize.binning import deferred_budget_checks
from ..renderer import MeshRenderer
from ..structures.meshes import Meshes
from ..structures.textures import TexturesUV
from ..utils.graph import StepGraph
from .history import MetricHistory


@dataclasses.dataclass(frozen=True)
class JointFitConfig:
    """The JAX package's settings and defaults. faces_per_pixel 8 (the
    reference's 50 adds nothing at sigma 1e-4), shade_k 2 (RGB is shaded
    on the two nearest slots; the silhouette keeps all), Adam lr 3e-3 for
    the vertices and 0.05 for the texture, halved every 500 steps.

    bin_size None = auto settings (rasterize/autotune.py), 0 = dense.
    max_faces_per_bin / active_tiles None = sized from the concrete scene
    with 1.5x head-room at make_dataset and fit set-up (active_tiles 0 =
    off). scan_segment (device-call segments of the JAX package's scan)
    and recon_points (a bin-local shading shortcut there) are accepted and
    have no effect here."""

    n_views: int = 15
    views_per_step: int = 2
    texture_size: int = 256
    n_steps: int = 2000
    lr_verts: float = 3e-3
    lr_texture: float = 0.05
    lr_decay_steps: int = 500
    lr_decay_rate: float = 0.5
    w_sil: float = 1.0
    w_rgb: float = 1.0
    w_edge: float = 1.0
    w_normal: float = 0.01
    w_laplacian: float = 1.0
    w_clamp: float = 1.0
    sigma: float = 1e-4
    faces_per_pixel: int = 8
    shade_k: int = 2
    scan_segment: int = 250
    bin_size: Optional[int] = 16
    max_faces_per_bin: Optional[int] = None
    active_tiles: Optional[int] = None
    recon_points: bool = True


class JointShapeTextureFitter:
    """The deform_mesh_with_color.py workload on one MeshRenderer, built on
    ``device`` (default: the card; see _device.resolve_device)."""

    def __init__(self, K, image_size: Tuple[int, int],
                 config: JointFitConfig = JointFitConfig(), device=None,
                 **renderer_kw):
        cfg = config
        self.config = cfg
        blur = math.log(1.0 / 1e-4 - 1.0) * cfg.sigma
        mfb = cfg.max_faces_per_bin if cfg.max_faces_per_bin else 128
        self.renderer = MeshRenderer(
            K, image_size, blur_radius=blur, sigma=cfg.sigma,
            faces_per_pixel=cfg.faces_per_pixel, bin_size=cfg.bin_size,
            max_faces_per_bin=mfb, shade_k=cfg.shade_k,
            active_tiles=cfg.active_tiles if cfg.active_tiles else None,
            recon_points=cfg.recon_points,
            device=resolve_device(device, like=K), **renderer_kw)
        self._auto_mfb = mfb
        self._auto_act = 0          # grows monotonically, like _auto_mfb

    @property
    def device(self) -> torch.device:
        return self.renderer.device

    def _ensure_bin_capacity(self, meshes: Meshes, Rs, ts) -> None:
        """Size max_faces_per_bin and active_tiles from the concrete scene
        (every view given) with 1.5x head-room: faces beyond a bin's budget
        are dropped, and the head-room absorbs the footprint's drift as the
        mesh deforms. Budgets only grow. Dense settings (bin_size 0) have
        no budgets, and auto settings (bin_size None) are measured at the
        first render of each batch shape (rasterize/autotune.py)."""
        cfg = self.config
        if not cfg.bin_size:
            return
        from ..rasterize.binning import (
            count_active_tiles,
            count_overflow,
            tile_grid,
        )
        from ..rasterize.geometry import setup_faces

        st = self.renderer.settings
        with torch.no_grad():
            fd = setup_faces(meshes, self.renderer.camera_with_pose(Rs, ts))
        pad = math.sqrt(st.blur_radius) if st.blur_radius > 0 else 0.0
        changed = {}
        if cfg.max_faces_per_bin is None:
            mx, _ = count_overflow(fd, self.renderer.image_size,
                                   cfg.bin_size, 0, pad)
            need = max(128, int(math.ceil(float(mx) * 1.5 / 128.0)) * 128)
            if need > self._auto_mfb:
                self._auto_mfb = need
                changed["max_faces_per_bin"] = need
        if cfg.active_tiles is None:
            na = int(count_active_tiles(fd, self.renderer.image_size,
                                        cfg.bin_size, pad))
            TH, TW, _ = tile_grid(self.renderer.image_size, cfg.bin_size)
            need_a = min(TH * TW, int(math.ceil(na * 1.5 / 8.0)) * 8)
            if need_a > self._auto_act:
                self._auto_act = need_a
                changed["active_tiles"] = need_a if need_a < TH * TW else None
        if changed:
            self.renderer.settings = dataclasses.replace(st, **changed)

    # -- dataset (reference :114-209) ----------------------------------------
    @torch.no_grad()
    def make_dataset(self, target_mesh: Meshes, dist: float = 2.7,
                     elev: float = 10.0) -> Dict[str, torch.Tensor]:
        """Render the N-view reference dataset at evenly spaced azimuths
        (-180 to 180 degrees, end excluded)."""
        n = self.config.n_views
        azims = np.linspace(-180.0, 180.0, n, endpoint=False,
                            dtype=np.float32)
        Rs, ts = look_at_view_transform(dist, elev, azims)
        Rs, ts = Rs.to(self.device), ts.to(self.device)
        batched = target_mesh.extend(n) if target_mesh.batch_size == 1 \
            else target_mesh
        self._ensure_bin_capacity(batched, Rs, ts)
        out = self.renderer.render(batched, Rs, ts, with_silhouette=True,
                                   with_rgb=True)
        return {"R": Rs, "t": ts, "rgb": out.rgb, "sil": out.silhouette,
                "depth": out.depth}

    # -- parameters ----------------------------------------------------------
    def init_params(self, src_mesh: Meshes, verts_uvs=None
                    ) -> Dict[str, torch.Tensor]:
        """{deform (V, 3) zeros, texture_map (T, T, 3) mid-grey}; verts_uvs
        is accepted for the JAX package's signature."""
        T = self.config.texture_size
        return {
            "deform": torch.zeros(src_mesh.verts.shape[-2:],
                                  device=src_mesh.device),
            "texture_map": torch.full((T, T, 3), 0.5,
                                      device=src_mesh.device),
        }

    # -- loss -----------------------------------------------------------------
    def loss(self, params: Dict[str, torch.Tensor], src_mesh: Meshes, topo,
             verts_uvs: torch.Tensor, dataset: Dict[str, torch.Tensor],
             view_idx: torch.Tensor):
        """(total, metrics) for the views view_idx of the dataset; metrics
        are 0-dim tensors: loss, sil_mse, rgb_mse, edge, normal, laplacian,
        clamp."""
        cfg = self.config
        v = view_idx.shape[0]
        mesh = src_mesh.offset_verts(params["deform"])
        tmap = params["texture_map"]
        tex = TexturesUV(
            maps=tmap[None].expand((v,) + tmap.shape),
            faces_uvs=src_mesh.faces[:1].expand(v, -1, -1),
            verts_uvs=verts_uvs[None].expand((v,) + verts_uvs.shape))
        batched = dataclasses.replace(mesh.extend(v), textures=tex)
        out = self.renderer.render(batched, dataset["R"][view_idx],
                                   dataset["t"][view_idx],
                                   with_silhouette=True, with_rgb=True)
        sil_mse = ((out.silhouette - dataset["sil"][view_idx]) ** 2).mean()
        rgb_mse = ((out.rgb - dataset["rgb"][view_idx]) ** 2).mean()
        edge = mesh_edge_loss(mesh, topo)
        normal = mesh_normal_consistency(mesh, topo)
        lap = mesh_laplacian_smoothing(mesh, topo)
        clamp = (torch.relu(tmap - 1.0) + torch.relu(-tmap)).mean()
        total = (cfg.w_sil * sil_mse + cfg.w_rgb * rgb_mse
                 + cfg.w_edge * edge + cfg.w_normal * normal
                 + cfg.w_laplacian * lap + cfg.w_clamp * clamp)
        return total, {"loss": total, "sil_mse": sil_mse, "rgb_mse": rgb_mse,
                       "edge": edge, "normal": normal, "laplacian": lap,
                       "clamp": clamp}

    # -- optimization ----------------------------------------------------------
    def view_schedule(self, generator: torch.Generator,
                      n: int) -> torch.Tensor:
        """(n, views_per_step) view subsets, each the first views_per_step
        of a random permutation (views without replacement), drawn from the
        generator on the host and placed on the device at once."""
        cfg = self.config
        idx = torch.stack([
            torch.randperm(cfg.n_views, generator=generator)[
                :cfg.views_per_step] for _ in range(n)]) if n else \
            torch.zeros((0, cfg.views_per_step), dtype=torch.int64)
        return idx.to(self.device)

    def fit(self, src_mesh: Meshes, verts_uvs, dataset: Dict,
            generator: Optional[torch.Generator] = None,
            n_steps: Optional[int] = None,
            params0: Optional[Dict] = None, capture=None):
        """Run the joint optimization; returns (params, history): history
        maps each metric name to its (n_steps,) tensor on the device, each
        step's metrics taken before its update. generator (a CPU
        torch.Generator; seed 0 when None) draws the view subsets.

        capture (utils/graph.py): None runs each iteration as a replay of
        one captured CUDA graph on the card (the JAX package's jitted scan
        segments) and eagerly on the CPU; True requires the card; False
        runs it eagerly. Either way the step reads its index from the
        device counter of its MetricHistory: its view subset is that row of
        the precomputed schedule, and the learning rates (float64 tensors,
        so the staircase lr * rate ** (i // lr_decay_steps) is the host's
        double arithmetic) are computed from it in the step. On the card
        Adam is capturable on either route."""
        cfg = self.config
        n = int(n_steps if n_steps is not None else cfg.n_steps)
        verts_uvs = torch.as_tensor(verts_uvs, dtype=torch.float32,
                                    device=self.device)
        src_batched = src_mesh.extend(cfg.n_views) \
            if src_mesh.batch_size == 1 else src_mesh
        self._ensure_bin_capacity(src_batched, dataset["R"], dataset["t"])
        topo = build_topology(src_mesh)
        p0 = params0 if params0 is not None else self.init_params(src_mesh)
        params = {k: v.detach().clone().to(self.device).requires_grad_(True)
                  for k, v in p0.items()}
        base = (cfg.lr_verts, cfg.lr_texture)
        lrs = [torch.tensor(lr, dtype=torch.float64, device=self.device)
               for lr in base]
        opt = torch.optim.Adam([
            {"params": [params["deform"]], "lr": lrs[0]},
            {"params": [params["texture_map"]], "lr": lrs[1]}],
            capturable=self.device.type == "cuda")
        rate = torch.tensor(cfg.lr_decay_rate, dtype=torch.float64,
                            device=self.device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        views = self.view_schedule(generator, n)
        history = MetricHistory(n, self.device)

        def iteration():
            i = history.step
            # optax.exponential_decay(staircase=True) at the update count
            scale = rate ** torch.div(i, cfg.lr_decay_steps,
                                      rounding_mode="floor")
            for lr_t, lr in zip(lrs, base):
                lr_t.copy_(lr * scale)
            opt.zero_grad(set_to_none=True)
            total, metrics = self.loss(params, src_mesh, topo, verts_uvs,
                                       dataset,
                                       views.index_select(0, i.view(1))[0])
            total.backward()
            opt.step()
            history.add(metrics)

        step = StepGraph(iteration, self.device, capture)
        with deferred_budget_checks():
            for _ in range(n):
                step()
        step.release()
        return {k: v.detach() for k, v in params.items()}, history.result()

    def textured_mesh(self, src_mesh: Meshes, verts_uvs,
                      params: Dict[str, torch.Tensor]) -> Meshes:
        """The fitted mesh with the fitted texture attached (for save_obj,
        the reference's result_colored.obj)."""
        verts_uvs = torch.as_tensor(verts_uvs, dtype=torch.float32,
                                    device=src_mesh.device)
        tex = TexturesUV(maps=params["texture_map"][None],
                         faces_uvs=src_mesh.faces[:1],
                         verts_uvs=verts_uvs[None])
        return dataclasses.replace(src_mesh.offset_verts(params["deform"]),
                                   textures=tex)

"""Two-phase deform-then-color pipeline, the mesh_deformer workload class
(PyTorch counterpart of ``torch_renderer_tpu.opt.creator``).

The rebuild of the reference's TheCreator (mesh_deformer.py:62-88): phase 1
deforms a source mesh onto a target by chamfer + regularizers
(geometry_train), phase 2 freezes the geometry and fits per-vertex RGB
against rendered views of the colored target (color_train). Exports OBJ or
PLY with vertex colors. Everything runs on the source mesh's device; on
the card both phases' steps are replays of captured CUDA graphs by default
(``capture``, as the fits take it).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..cameras.look_at import look_at_view_transform
from ..ops.color_transfer import query_vertex_colors
from ..structures.meshes import Meshes
from ..structures.textures import TexturesVertex
from .deform import ColorFitConfig, DeformConfig, MeshDeformer, VertexColorFitter


@dataclasses.dataclass(frozen=True)
class CreatorConfig:
    geometry: DeformConfig = DeformConfig()
    color: ColorFitConfig = ColorFitConfig()
    n_color_views: int = 10          # the reference renders 10 views
    view_dist: float = 2.7
    view_elev: float = 15.0
    image_size: Tuple[int, int] = (128, 128)
    focal_scale: float = 0.9


class TwoPhaseCreator:
    """geometry_train -> color_train, on the TheCreator surface."""

    def __init__(self, src_mesh: Meshes, target_mesh: Meshes,
                 config: CreatorConfig = CreatorConfig()):
        self.config = config
        self.src = src_mesh
        self.target = target_mesh
        H, W = config.image_size
        f = config.focal_scale * min(H, W)
        self.K = np.array(
            [[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]], np.float32)
        self.deformed: Optional[Meshes] = None
        self.verts_rgb: Optional[torch.Tensor] = None

    # -- phase 1 --------------------------------------------------------------
    def geometry_train(self, generator: Optional[torch.Generator] = None,
                       n_steps: Optional[int] = None,
                       snapshot_every: int = 0, capture=None) -> Dict:
        """The chamfer deformation; generator (on the source mesh's device)
        draws the surface samples. capture: MeshDeformer.fit's."""
        deformer = MeshDeformer(self.src, target_meshes=self.target,
                                config=self.config.geometry)
        mesh, deform, hist, snaps = deformer.fit(
            generator, n_steps=n_steps, snapshot_every=snapshot_every,
            capture=capture)
        self.deformed = mesh
        return {"mesh": mesh, "deform": deform, "history": hist,
                "snapshots": snaps}

    # -- phase 2 --------------------------------------------------------------
    def color_train(self, generator: Optional[torch.Generator] = None,
                    n_steps: Optional[int] = None, capture=None) -> Dict:
        """Fit per-vertex RGB of the (frozen) deformed mesh from rendered
        views of the colored target. Needs geometry_train first and a
        target with TexturesVertex; for targets without colors use
        transfer_colors(). The fit draws nothing: generator is accepted
        for the surface's symmetry with geometry_train (the JAX package's
        key). capture: VertexColorFitter.fit's."""
        if self.deformed is None:
            raise RuntimeError("run geometry_train before color_train")
        cfg = self.config
        if not isinstance(self.target.textures, TexturesVertex):
            raise ValueError(
                "color_train needs a TexturesVertex-colored target; for "
                "uncolored targets use transfer_colors() instead")
        device = self.deformed.device
        azims = torch.linspace(-180.0, 180.0, cfg.n_color_views + 1)[:-1]
        Rs, ts = look_at_view_transform(cfg.view_dist, cfg.view_elev, azims)
        Rs, ts = Rs.to(device), ts.to(device)
        fitter = VertexColorFitter(self.K, cfg.image_size, cfg.color,
                                   device=device)
        refs = fitter.make_reference_views(self.target, Rs, ts)
        verts_rgb, hist = fitter.fit(self.deformed, Rs, ts, refs,
                                     n_steps=n_steps, capture=capture)
        self.verts_rgb = verts_rgb
        return {"verts_rgb": verts_rgb, "history": hist, "refs": refs}

    def transfer_colors(self) -> torch.Tensor:
        """Direct nearest-vertex color transfer from the target's vertex
        colors (the deform_mesh_from_pcd.py:241-250 reattach path)."""
        if self.deformed is None:
            raise RuntimeError("run geometry_train before transfer_colors")
        tex = self.target.textures
        if not isinstance(tex, TexturesVertex):
            raise ValueError("target has no vertex colors")
        self.verts_rgb = query_vertex_colors(
            self.deformed.verts, self.target.verts, tex.verts_features,
            ref_mask=self.target.vert_mask())[0]
        return self.verts_rgb

    # -- export ----------------------------------------------------------------
    def export(self, path: str) -> None:
        """Write the colored result as OBJ (xyzrgb verts) or PLY."""
        if self.deformed is None:
            raise RuntimeError("nothing to export")
        v, f = self.deformed.detach_to_lists()[0]
        rgb = (np.clip(self.verts_rgb.detach().cpu().numpy(), 0, 1)
               [: v.shape[0]] if self.verts_rgb is not None else None)
        if path.endswith(".ply"):
            from ..io.ply import save_ply

            save_ply(path, v, faces=f, colors=rgb)
        else:
            from ..io.obj import save_obj

            save_obj(path, v, f, verts_rgb=rgb)

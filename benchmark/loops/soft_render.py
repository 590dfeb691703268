"""Forward soft silhouettes of pose hypotheses, no gradient: each step copies
the next batch of rotations from a seeded pool into the call's static
inputs and renders it, the traffic of scoring poses by their silhouettes.

The call is face planes (``rasterize.geometry.setup_face_planes``) ->
``rasterize.cuda_soft.soft_silhouette_fd`` with the budget checks off, under
``utils.graph.CapturedCall``, sized once at set-up over the whole pool by
``suggest_soft_config(layout="packed")``. Each step's images are copied into
a preallocated result of the whole pool (a replay overwrites its outputs),
which the check compares after the window. The pool is the scene's views.
"""

from __future__ import annotations

import torch

from reference.soft import soft_alpha

# The widest |alpha - reference| over the pool (PERF.md gives the readings).
LIMITS = {"alpha_gap": 3e-3}


def scene_views(config: dict, traffic: dict) -> int:
    return traffic["pool"]


class Loop:
    def __init__(self, scene: dict, traffic: dict, device):
        from torch_renderer_tpu_torch.cameras.perspective import (
            PerspectiveCamera,
        )
        from torch_renderer_tpu_torch.rasterize import cuda_soft
        from torch_renderer_tpu_torch.rasterize.geometry import (
            setup_face_planes,
        )
        from torch_renderer_tpu_torch.structures.meshes import Meshes
        from torch_renderer_tpu_torch.utils.graph import CapturedCall

        R, t, K = scene["R"], scene["t"], scene["K"]
        B = traffic["batch"]
        V, F = scene["verts"].shape[0], scene["faces"].shape[0]
        size, sigma = scene["image_size"], scene["config"]["sigma"]
        self.images_per_step = B
        self.cycle = R.shape[0] // B
        meshes = Meshes(
            verts=scene["verts"][None].expand(B, V, 3),
            faces=scene["faces"][None].expand(B, F, 3),
            num_verts=torch.full((B,), V, dtype=torch.int64, device=device),
            num_faces=torch.full((B,), F, dtype=torch.int64, device=device))
        cam = PerspectiveCamera.from_K(K[None].expand(B, 3, 3), size,
                                       R=R[:B], t=t[:B], device=device)
        self.batches = [R[j * B:(j + 1) * B].contiguous()
                        for j in range(self.cycle)]
        with torch.no_grad():
            fps = [setup_face_planes(meshes, cam.replace_pose(Rb, cam.t))
                   for Rb in self.batches]
        self.sizing = cuda_soft.suggest_soft_config(
            fps, size, sigma=sigma, layout="packed")
        kw = self.sizing.kwargs()
        del fps

        @torch.no_grad()
        def render(Rb):
            fp = setup_face_planes(meshes, cam.replace_pose(Rb, cam.t))
            return cuda_soft.soft_silhouette_fd(fp, size, sigma=sigma,
                                                check_budgets="off", **kw)

        self.call = CapturedCall(render, device)
        self.alpha = torch.empty((R.shape[0],) + tuple(size), device=device)
        self.step(0)

    def step(self, i: int) -> None:
        j = i % self.cycle
        B = self.images_per_step
        self.alpha[j * B:(j + 1) * B].copy_(self.call(self.batches[j]))

    def step_views(self, i: int) -> range:
        j = i % self.cycle
        return range(j * self.images_per_step,
                     (j + 1) * self.images_per_step)

    def result(self) -> dict:
        return {"alpha": self.alpha}

    def release(self) -> None:
        self.call.release()


def check(result: dict, scene: dict, traffic: dict):
    ref = soft_alpha(scene["verts"], scene["faces"], scene["K"], scene["R"],
                     scene["t"], scene["image_size"],
                     scene["config"]["sigma"])
    gap = float((result["alpha"] - ref).abs().max())
    return [("alpha_gap", gap, LIMITS["alpha_gap"])]


def control(result: dict, scene: dict, traffic: dict) -> dict:
    return {"alpha": soft_alpha(scene["verts"], scene["faces"], scene["K"],
                                scene["R"], scene["t"], scene["image_size"],
                                scene["config"]["sigma"],
                                dtype=torch.bfloat16)}

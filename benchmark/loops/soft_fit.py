"""The inner step of a silhouette fit, chained: v <- v - lr * d sum(alpha) / dv
over all the views at once.

The step's math is a frozen copy of ``torch_renderer_tpu_torch/bench.py``
``make_step`` (``:77-131``): face planes (``rasterize.geometry.
setup_face_planes``) -> ``rasterize.cuda_soft.soft_silhouette_fd`` with the
budget checks off, sized once on the start projection by
``suggest_soft_config(layout="packed")`` -> autograd. It runs as two
``utils.graph.StepGraph`` replays that take turns, one reading buffer 0 and
writing buffer 1, the other the reverse, so that the state before the last
step is still there for the check. Every ``restart_every``-th step first
copies the start vertices back into buffer 0: at lr 1e-6 a vertex moves up
to about 5.6e-4 a step, so an unbroken chain would fold the mesh within
seconds and change the work as it went.

A step takes no input from the host, and completes one rendered and
differentiated image a view.
"""

from __future__ import annotations

import torch

from reference.soft import soft_alpha

# The compared numbers' limits (PERF.md gives the readings they were set
# from): the widest |alpha - reference| of the first and the last step;
# the gradient's gap from the reference's, as a share of the reference's
# norm over every vertex of every view; the last update's gap from
# prev - lr * reference gradient, as a share of that step's norm. The
# gradients are compared whole and not by the worst vertex: where a pixel
# lies on a face's medial axis its two nearest edges tie, and float32
# rounding picks either (the kernel, its plain version and the reference
# compute the distances in other forms), which can move one vertex's
# gradient by a few percent of the largest.
LIMITS = {"alpha_gap": 3e-3, "grad_gap": 0.02, "step_gap": 0.05}


def scene_views(config: dict, traffic: dict) -> int:
    return config["views"]


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
        from torch_renderer_tpu_torch.utils.graph import StepGraph

        R, t, K = scene["R"], scene["t"], scene["K"]
        B = R.shape[0]
        V, F = scene["verts"].shape[0], scene["faces"].shape[0]
        size, sigma = scene["image_size"], scene["config"]["sigma"]
        lr = traffic["lr"]
        self.restart = traffic["restart_every"]
        self.images_per_step, self.cycle = B, 2
        meshes = Meshes(
            verts=scene["verts"][None].expand(B, V, 3),
            faces=scene["faces"][None].expand(B, F, 3),
            num_verts=torch.full((B,), V, dtype=torch.int64, device=device),
            num_faces=torch.full((B,), F, dtype=torch.int64, device=device))
        cam = PerspectiveCamera.from_K(K[None].expand(B, 3, 3), size, R=R,
                                       t=t, device=device)
        with torch.no_grad():
            fp0 = setup_face_planes(meshes, cam)
        self.sizing = cuda_soft.suggest_soft_config(
            fp0, size, sigma=sigma, layout="packed")
        kw = self.sizing.kwargs()

        def grad(v):
            v = v.detach().requires_grad_(True)
            fp = setup_face_planes(meshes.update_padded(v), cam)
            alpha = cuda_soft.soft_silhouette_fd(fp, size, sigma=sigma,
                                                 check_budgets="off", **kw)
            (g,) = torch.autograd.grad(alpha.sum(), v)
            return alpha.detach(), g

        self.v0 = meshes.verts.detach().clone()
        self.bufs = [self.v0.clone(), self.v0.clone()]

        def body(j):
            src, dst = self.bufs[j], self.bufs[1 - j]
            alpha, g = grad(src)
            dst.copy_(src - lr * g)
            return alpha, g

        self.graphs = [StepGraph(lambda: body(0), device),
                       StepGraph(lambda: body(1), device)]
        # the first call of each graph is its eager warm-up, the second its
        # capture and first replay
        for j in (0, 1, 0, 1):
            self.graphs[j]()
        self.first = self.last = (None, None, 0)

    def step(self, i: int) -> None:
        j = i % 2
        if i % self.restart == 0:
            self.bufs[0].copy_(self.v0)
        alpha, g = self.graphs[j]()
        if i == 0:
            # step 0, a replay from the start vertices, is kept for the
            # check of the start: the measured window's own step 0 is the
            # last to write it
            self.first = (alpha.clone(), g.clone())
        self.last = (alpha, g, j)

    def step_views(self, i: int) -> range:
        return range(self.images_per_step)

    def result(self) -> dict:
        alpha, g, j = self.last
        return {"first_alpha": self.first[0], "first_g": self.first[1],
                "v0": self.v0, "prev": self.bufs[j].clone(),
                "next": self.bufs[1 - j].clone(), "alpha": alpha.clone(),
                "g": g.clone()}

    def release(self) -> None:
        for graph in self.graphs:
            graph.release()
        self.graphs = []


def _gap(x, ref) -> float:
    """||x - ref|| / ||ref||, over every element."""
    return float((x - ref).norm() / ref.norm().clamp_min(1e-30))


def check(result: dict, scene: dict, traffic: dict):
    """[(name, value, limit)] of the first and the last step against the
    reference from the same vertices."""
    args = (scene["faces"], scene["K"], scene["R"], scene["t"],
            scene["image_size"], scene["config"]["sigma"])
    lr = traffic["lr"]
    a0, g0 = soft_alpha(result["v0"], *args, grad=True)
    a1, g1 = soft_alpha(result["prev"], *args, grad=True)
    alpha_gap = max(float((result["first_alpha"] - a0).abs().max()),
                    float((result["alpha"] - a1).abs().max()))
    grad_gap = max(_gap(result["first_g"], g0), _gap(result["g"], g1))
    step_gap = _gap(result["next"] - result["prev"], -lr * g1)
    return [("alpha_gap", alpha_gap, LIMITS["alpha_gap"]),
            ("grad_gap", grad_gap, LIMITS["grad_gap"]),
            ("step_gap", step_gap, LIMITS["step_gap"])]


def control(result: dict, scene: dict, traffic: dict) -> dict:
    """The result the reference gives in bfloat16 in the program's place,
    from the same vertices."""
    args = (scene["faces"], scene["K"], scene["R"], scene["t"],
            scene["image_size"], scene["config"]["sigma"])
    bf = torch.bfloat16
    a0, g0 = soft_alpha(result["v0"], *args, grad=True, dtype=bf)
    a1, g1 = soft_alpha(result["prev"], *args, grad=True, dtype=bf)
    nxt = (result["prev"].to(bf) - traffic["lr"] * g1.to(bf)).float()
    return {**result, "first_alpha": a0, "first_g": g0, "alpha": a1,
            "g": g1, "next": nxt}

"""Batched depth renders in calls of ``views_per_call`` views, cycled through
the scene's views, as the port's ``apps/batch_render_bench.py`` runs them.

Each call copies its chunk's (R, t) into the static inputs of a
``utils.graph.CapturedCall`` of ``renderer.DepthRender.render`` (camera
transform, face set-up, binning, ``hard_k1``, gather, ``untile``) and
replays it; its depth is copied into a preallocated result of every view,
as the app does. The budgets are sized at set-up from all the views by the
app's calls (``count_overflow`` x 1.3, ``suggest_active_tiles_fd``,
``suggest_occupancy_split_fd``); the renderer's settings are the app's,
its budget checks too: they record their counts on the device ("warn"),
read once after the window.
"""

from __future__ import annotations

import torch

from reference.depth import depth

# A pixel is "off" when its depth differs from the reference's by more
# than OFF (absolute; depths here lie near 1.7 to 3.7). The limits are on
# the share of off pixels and on the mean |gap| over the pixels either side
# covers (PERF.md gives the readings they were set from).
OFF = 1e-3
LIMITS = {"depth_off_share": 1.5e-4, "depth_gap_mean": 2e-4}


def scene_views(config: dict, traffic: dict) -> int:
    return config["views"]


class Loop:
    def __init__(self, scene: dict, traffic: dict, device):
        from torch_renderer_tpu_torch.cameras.perspective import (
            PerspectiveCamera,
        )
        from torch_renderer_tpu_torch.rasterize.binning import (
            count_overflow,
            suggest_active_tiles_fd,
            suggest_occupancy_split_fd,
        )
        from torch_renderer_tpu_torch.rasterize.geometry import setup_faces
        from torch_renderer_tpu_torch.renderer import DepthRender
        from torch_renderer_tpu_torch.structures.meshes import Meshes
        from torch_renderer_tpu_torch.utils.graph import CapturedCall

        R, t, K = scene["R"], scene["t"], scene["K"]
        N = R.shape[0]
        vc = traffic["views_per_call"]
        if N % vc:
            raise ValueError(f"{N} views do not split into calls of {vc}")
        size, bin_size = scene["image_size"], scene["config"]["bin"]
        V, F = scene["verts"].shape[0], scene["faces"].shape[0]
        self.images_per_step, self.cycle = vc, N // vc
        one = Meshes(verts=scene["verts"][None], faces=scene["faces"][None],
                     num_verts=torch.full((1,), V, device=device),
                     num_faces=torch.full((1,), F, device=device))
        cam0 = PerspectiveCamera.from_K(K, size, R=R, t=t, device=device)
        with torch.no_grad():
            fd0 = setup_faces(one.extend(N), cam0)
        max_count, _ = count_overflow(fd0, size, bin_size, 0, 0.0)
        mfb = max(8, int(float(max_count) * 1.3))
        act = suggest_active_tiles_fd(fd0, size, bin_size, 0.0)
        split = suggest_occupancy_split_fd(fd0, size, bin_size, 0.0, act, mfb)
        del fd0, cam0
        self.sizing = {"max_faces_per_bin": mfb, "active_tiles": act,
                       "occupancy_split": split}
        renderer = DepthRender(
            K, size, pixel_chunk=1048576, bin_size=bin_size,
            max_faces_per_bin=mfb, impl="auto", active_tiles=act,
            occupancy_split=split, select_impl="affine",
            check_budgets="warn", device=device)
        batched = one.extend(vc)

        @torch.no_grad()
        def render(Rc, tc):
            return renderer.render(batched, Rc, tc)

        self.call = CapturedCall(render, device)
        self.chunks = [(R[c * vc:(c + 1) * vc].contiguous(),
                        t[c * vc:(c + 1) * vc].contiguous())
                       for c in range(self.cycle)]
        self.depth = torch.empty((N,) + tuple(size), device=device)
        self.step(0)

    def step(self, i: int) -> None:
        c = i % self.cycle
        vc = self.images_per_step
        self.depth[c * vc:(c + 1) * vc].copy_(self.call(*self.chunks[c]))

    def step_views(self, i: int) -> range:
        c = i % self.cycle
        return range(c * self.images_per_step,
                     (c + 1) * self.images_per_step)

    def result(self) -> dict:
        self.call.warn_budgets()
        return {"depth": self.depth}

    def release(self) -> None:
        self.call.release()


def check(result: dict, scene: dict, traffic: dict):
    ref = depth(scene["verts"], scene["faces"], scene["K"], scene["R"],
                scene["t"], scene["image_size"])
    gap = (result["depth"] - ref).abs()
    either = (result["depth"] > 0) | (ref > 0)
    off = float((gap > OFF).double().mean())
    mean = float(gap[either].double().mean()) if bool(either.any()) else 0.0
    return [("depth_off_share", off, LIMITS["depth_off_share"]),
            ("depth_gap_mean", mean, LIMITS["depth_gap_mean"])]


def control(result: dict, scene: dict, traffic: dict) -> dict:
    return {"depth": depth(scene["verts"], scene["faces"], scene["K"],
                           scene["R"], scene["t"], scene["image_size"],
                           dtype=torch.bfloat16)}

"""Point-renderer throughput on one card: the port's twin of the JAX
package's ``scripts/bench_points.py`` (splat rasterization and the three
compositors, forward renders and a gradient step).

Scene, the JAX script's defaults: B=4 clouds of 20000 points, 0.8 N(0, 1),
with uniform [0, 1) RGB features, both from np.random.default_rng(0);
256x256, f = 0.8 * 256, principal point at the centre, R = I,
t = (0, 0, 2.5); radius 0.01, K = 8, tile 16. Budgets as the JAX script
sizes them: suggest_points_per_bin for the splat radius and again with the
sphere renderer's per-point NDC radii r_ndc, suggest_active_tiles_points
for both.

Rows, the JAX script's nine with its names: dense alpha (left out under
--skip-dense), DEFAULT auto (resolved by prepare() before any capture),
binned "xla", binned "pallas", pallas+act, norm, Pulsar splat, Pulsar
sphere and sphere+act. The port's impl selects nothing for points: the
"xla" and "pallas" rows both run the points_select kernel.

Bodies: the forward render(pc(p), R, t) and the grad step d sum(render^2)
/ dp, each chained as the JAX script's lax.scan chains it: the next input
is c + 1e-30 * sum(outputs). On the card each body is a utils.graph
StepGraph replay, one host call a step (the counterpart of the jitted
scan); --eager launches its kernels from the host; the CPU runs eagerly.
Budget checks are deferred (binning.deferred_budget_checks, the auto
row's "warn"), so nothing in a step reads the device.

Timing: each body runs `steps` chained steps once (on the card the eager
warm-up and the capture), then `repeats` times, each timed by CUDA events
(the host clock on the CPU); a row's ms is the best repeat's ms a step
less that of a trivial body, sum(p), chained and timed alike, as the JAX
script nets its floor. Every repeat is printed too.

The lines before the last give the card, the budgets, each row's repeats
and the JAX script's markdown table; the last line is one JSON object with
each row's forward ms, grad step ms and form, and n_chips.

--quick: B=2 clouds of 1500 points at 64x64, 2 steps, 1 repeat.

  python -m torch_renderer_tpu_torch.bench_points
  python -m torch_renderer_tpu_torch.bench_points --eager
  python -m torch_renderer_tpu_torch.bench_points --quick --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ._device import resolve_device
from .bench import card_line
from .rasterize.binning import deferred_budget_checks
from .rasterize.points import (
    PointsRasterizationSettings,
    suggest_active_tiles_points,
    suggest_points_per_bin,
)
from .renderer import (
    AlphaPointRender,
    NormPointRender,
    PulsarPointRender,
    PulsarRenderer,
)
from .structures.pointclouds import Pointclouds
from .utils.graph import StepGraph

RADIUS = 0.01
TILE = 16
FULL = dict(batch=4, points=20000, image=256, steps=20, repeats=5)
QUICK = dict(batch=2, points=1500, image=64, steps=2, repeats=1)
DENSE = "alpha (dense)"
BODIES = ("forward", "grad step")


def scene(batch: int, points: int, image: int, device):
    """The JAX script's scene: (cloud, K as a numpy (3, 3), R, t)."""
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((batch, points, 3)).astype(np.float32) * 0.8
    feats = rng.uniform(0.0, 1.0, (batch, points, 3)).astype(np.float32)
    cloud = Pointclouds.from_padded(pts, features=feats, device=device)
    f = 0.8 * image
    K = np.array([[f, 0, image / 2.0], [0, f, image / 2.0], [0, 0, 1.0]],
                 np.float32)
    R = torch.eye(3, device=device).expand(batch, 3, 3).contiguous()
    t = torch.tensor([0.0, 0.0, 2.5], device=device).expand(batch, 3)
    return cloud, K, R, t.contiguous()


def size_budgets(cloud: Pointclouds, K, R, t, image: int, device) -> dict:
    """The JAX script's four budgets (host reads: set-up only): points
    per bin and active tiles for the splat radius ("mpb", "act") and for
    the sphere renderer's r_ndc ("mpb_sphere", "act_sphere")."""
    size = (image, image)
    probe = PointsRasterizationSettings(image_size=size, radius=RADIUS,
                                        bin_size=TILE)
    cam = AlphaPointRender(K, size, device=device).camera_with_pose(R, t)
    sph = PulsarRenderer(K, size, radius=RADIUS, bin_size=TILE,
                         device=device)
    cam_s = sph.camera_with_pose(R, t)
    with torch.no_grad():
        _, _, r_ndc = sph._selection_radii(cloud, cam_s)
    return {"mpb": suggest_points_per_bin(cloud, cam, probe),
            "mpb_sphere": suggest_points_per_bin(cloud, cam_s, probe,
                                                 radius=r_ndc),
            "act": suggest_active_tiles_points(cloud, cam, probe),
            "act_sphere": suggest_active_tiles_points(cloud, cam_s, probe,
                                                      radius=r_ndc)}


def make_renderers(cloud: Pointclouds, K, R, t, image: int, budgets: dict,
                   device, skip_dense: bool = False):
    """The JAX script's rows, by its names, and the DEFAULT row's
    auto-resolved settings (prepare(): its budgets are measured here, so
    no later render reads the device)."""
    size = (image, image)
    bkw = dict(radius=RADIUS, bin_size=TILE,
               max_points_per_bin=budgets["mpb"], device=device)
    sphere = dict(radius=RADIUS, bin_size=TILE,
                  max_points_per_bin=budgets["mpb_sphere"], device=device)
    default = AlphaPointRender(K, size, radius=RADIUS, device=device)
    auto = default.prepare(cloud, R, t)
    rows = {
        **({} if skip_dense else {DENSE: AlphaPointRender(
            K, size, radius=RADIUS, bin_size=0, device=device)}),
        "alpha (DEFAULT auto)": default,
        "alpha (binned xla)": AlphaPointRender(K, size, impl="xla", **bkw),
        "alpha (binned pallas)": AlphaPointRender(K, size, impl="pallas",
                                                  **bkw),
        "alpha (binned pallas+act)": AlphaPointRender(
            K, size, impl="pallas", active_tiles=budgets["act"], **bkw),
        "norm (binned)": NormPointRender(K, size, **bkw),
        "pulsar_splat (binned)": PulsarPointRender(K, size, **bkw),
        "pulsar_sphere (binned)": PulsarRenderer(K, size, **sphere),
        "pulsar_sphere (binned+act)": PulsarRenderer(
            K, size, active_tiles=budgets["act_sphere"], **sphere),
    }
    return rows, auto


def bodies(renderer, cloud: Pointclouds, R, t) -> dict:
    """The row's two bodies, each p -> output: the forward render of the
    cloud at points p, and the grad step d sum(render^2) / dp."""
    def forward(p):
        return renderer.render(dataclasses.replace(cloud, points=p), R, t)

    def grad_step(p):
        x = p.detach().requires_grad_(True)
        img = forward(x)
        (g,) = torch.autograd.grad((img * img).sum(), x)
        return g

    return {"forward": forward, "grad step": grad_step}


class Chain:
    """Calls of ``step()``, each one step of fn chained as the JAX
    script's scan chains it: out = fn(c), then c <- c + 1e-30 * sum(out),
    with c a buffer made from p0 that the step updates in place. capture
    as StepGraph takes it (None: captured on the card, eager elsewhere);
    a captured step returns the capture's output, which each replay
    rewrites."""

    def __init__(self, fn, p0: torch.Tensor, capture=None):
        self.c = p0.detach().clone()

        def body():
            out = fn(self.c)
            self.c.copy_(self.c + 1e-30 * out.sum())
            return out

        self.graph = StepGraph(body, self.c.device, capture)

    @property
    def captured(self) -> bool:
        return self.graph.captured

    def step(self):
        return self.graph()

    def release(self) -> None:
        self.graph.release()


def time_steps(chain: Chain, steps: int, repeats: int) -> list:
    """`steps` chained steps once (the warm-up; on the card the eager
    first step and the capture), then ms a step of each of `repeats` runs
    of `steps`: CUDA events on the card, the host clock on the CPU."""
    cuda = chain.c.is_cuda
    for _ in range(steps):
        chain.step()
    out = []
    for _ in range(repeats):
        if cuda:
            torch.cuda.synchronize(chain.c.device)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(steps):
            chain.step()
        if cuda:
            stop.record()
            torch.cuda.synchronize(chain.c.device)
            ms = start.elapsed_time(stop)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        out.append(ms / steps)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="B=2 clouds of 1500 points at 64x64, 2 steps, "
                         "1 repeat")
    ap.add_argument("--device", default=None,
                    help="default: the current card (cpu to run there)")
    ap.add_argument("--eager", action="store_true",
                    help="launch each step's kernels from the host "
                         "(default: replay each body as a captured CUDA "
                         "graph on the card; the CPU runs eagerly either "
                         "way)")
    ap.add_argument("--skip-dense", action="store_true",
                    help="leave out the O(pixels x points) dense row")
    for k in FULL:
        ap.add_argument(f"--{k}", type=int, default=None,
                        help=f"default {FULL[k]} ({QUICK[k]} with --quick)")
    args = ap.parse_args(argv)
    p = {k: getattr(args, k) or v
         for k, v in (QUICK if args.quick else FULL).items()}
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    capture = False if args.eager else None
    form = "captured CUDA graph" if on_card and not args.eager else "eager"
    print(card_line() if on_card else f"device: {device} (no card timing)",
          flush=True)

    B, N, S = p["batch"], p["points"], p["image"]
    cloud, K, R, t = scene(B, N, S, device)
    bud = size_budgets(cloud, K, R, t, S, device)
    print(f"auto max_points_per_bin = {bud['mpb']}", flush=True)
    print(f"auto max_points_per_bin (sphere r_ndc) = {bud['mpb_sphere']}",
          flush=True)
    print(f"auto active_tiles = {bud['act']} (sphere {bud['act_sphere']})",
          flush=True)
    renderers, auto = make_renderers(cloud, K, R, t, S, bud, device,
                                     args.skip_dense)
    print(f"DEFAULT auto-resolved: bin_size={auto.bin_size} "
          f"max_points_per_bin={auto.max_points_per_bin} "
          f"active_tiles={auto.active_tiles} "
          f"check_budgets={auto.check_budgets}", flush=True)
    print("impl selects nothing for points: the binned \"xla\" and "
          "\"pallas\" rows both run the points_select kernel", flush=True)

    clock = "CUDA events" if on_card else "host clock"
    with deferred_budget_checks():
        floor_chain = Chain(lambda c: c.sum(), cloud.points, capture)
        floor_reps = time_steps(floor_chain, p["steps"], p["repeats"])
        floor_chain.release()
        floor = min(floor_reps)
        print(f"floor {floor:.3f} ms | {B}x{N} points at {S}^2, K="
              f"{auto.points_per_pixel}; each body: {form}, {p['steps']} "
              f"steps, best of {p['repeats']} ({clock})", flush=True)
        rows = {}
        for name, r in renderers.items():
            reps = {}
            for body, fn in bodies(r, cloud, R, t).items():
                chain = Chain(fn, cloud.points, capture)
                reps[body] = time_steps(chain, p["steps"], p["repeats"])
                chain.release()
            rows[name] = {"forward_ms": min(reps["forward"]) - floor,
                          "grad_step_ms": min(reps["grad step"]) - floor,
                          "form": form, "repeats_ms": reps}
            print(f"{name}: repeats (ms a step) forward "
                  + ", ".join(f"{x:.4f}" for x in reps["forward"])
                  + "; grad step "
                  + ", ".join(f"{x:.4f}" for x in reps["grad step"]),
                  flush=True)
    print("| renderer | forward ms | grad step ms | imgs/s (fwd) |")
    print("|---|---|---|---|")
    for name, row in rows.items():
        tf = row["forward_ms"]
        fps = f"{B / tf * 1e3:.0f}" if tf > 0 else "inf"
        print(f"| {name} | {tf:.3f} | {row['grad_step_ms']:.3f} | {fps} |",
              flush=True)
    record = {"rows": {n: {k: r[k] for k in ("forward_ms", "grad_step_ms",
                                             "form")}
                       for n, r in rows.items()},
              "floor_ms": floor, "n_chips": 1}
    print(json.dumps(record), flush=True)
    return {**record, "rows": rows, "floor_repeats_ms": floor_reps,
            "budgets": bud, "auto": dataclasses.asdict(auto), "params": p}


if __name__ == "__main__":
    main()

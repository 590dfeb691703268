"""Soft-silhouette render + backward benchmark on one card: the protocol of
the repository's ``bench.py``, redone for the port.

Scene: B=8 views of a level-3 icosphere (1280 faces) at t = (0, 0, 3), seen
with f = 0.8 * 256 at 256x256, sigma 1e-4. Sizing: suggest_soft_config(...,
layout="packed") once, on the start projection. Step: v <- v - 1e-6 *
d sum(alpha) / dv through soft_silhouette_fd with the budget checks off, so
nothing in a step reads a device value back to the host; on the card the
step is captured once in a CUDA graph and replayed (bench.py runs its
steps as one jitted lax.scan), with --eager its kernels are launched from
the host each step. Timing: 10 warm-up steps, then 100 steps timed by CUDA
events (by the host clock on the CPU), in each of 5 passes; the result is
the median img/s of the passes, with their min-max spread. One profiled
step gives the kernels launched per step.

--quick: B=2, 128x128, a level-2 icosphere, 5 timed steps after 1 warm-up
step, 3 passes.

Several cards (--cards N, default every visible card): weak scaling, as
bench.py's multi-chip branch. One rank a card (parallel.launch.run_ranks
with its default backend: NCCL, gloo where ranks share a card), B views
per card from a whole batch of B x N, each rank its slice
(parallel.shard_batch); no collective in the step, which each rank
captures and replays as on one card. Each rank times its own passes; the
value is the ranks' summed median img/s over the card count (img/s per
card), with n_chips the card count.

The lines before the last give the card, the sizing, the passes and the
launches. The last line is one JSON object with bench.py's keys (metric,
value, unit, vs_baseline, n_chips); vs_baseline is value over the cpu_fps
of the tracked .bench_cpu_baseline.json (bench.py's torch-CPU reference of
the full scene, read here and never written), and null under --quick,
whose scene that reference is not of.

  python -m torch_renderer_tpu_torch.bench
  python -m torch_renderer_tpu_torch.bench --eager
  python -m torch_renderer_tpu_torch.bench --quick --device cpu
  python -m torch_renderer_tpu_torch.bench --cards 4
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ._device import resolve_device
from .cameras.perspective import PerspectiveCamera
from .ops.icosphere import icosphere
from .rasterize import cuda_soft
from .rasterize.geometry import setup_face_planes
from .structures.meshes import Meshes
from .utils import timing
from .utils.graph import StepGraph

SIGMA = 1e-4
METRIC = "softsil_256_render_backward_fps_per_chip"
FULL = dict(batch=8, image=256, level=3, steps=100, warmup=10, passes=5)
QUICK = dict(batch=2, image=128, level=2, steps=5, warmup=1, passes=3)
BASELINE = Path(__file__).resolve().parents[1] / ".bench_cpu_baseline.json"


def scene(batch: int, image: int, level: int, device):
    """bench.py's scene: the icosphere at t = (0, 0, 3), f = 0.8 * image,
    principal point at the centre, replicated over the batch."""
    verts, faces = icosphere(level)
    f = 0.8 * image
    K = np.array([[f, 0, image / 2.0], [0, f, image / 2.0], [0, 0, 1.0]],
                 np.float32)
    t = np.tile(np.array([0.0, 0.0, 3.0], np.float32), (batch, 1))
    meshes = Meshes.from_single(verts, faces, device=device).extend(batch)
    cam = PerspectiveCamera.from_K(np.tile(K[None], (batch, 1, 1)),
                                   (image, image), t=t, device=device)
    return meshes, cam


def make_step(meshes: Meshes, cam: PerspectiveCamera, sigma: float = SIGMA,
              cfg: cuda_soft.SoftKernelConfig | None = None, capture=None):
    """The chained step and its sizing: step(v) -> (v - 1e-6 * g, g) with g
    = d sum(alpha) / dv. cfg defaults to suggest_soft_config(layout=
    "packed") of the start projection, sized here once.

    capture (utils/graph.py): False gives the eager step, which returns a
    new v each call. Otherwise v lives in a static buffer that the step
    updates in place, v.copy_(v - 1e-6 * g), and returns: captured in a
    CUDA graph and replayed on the card by default (one host call a step,
    the counterpart of bench.py's jitted lax.scan), run eagerly on the CPU.
    A v other than the buffer is copied into it first."""
    size = cam.image_size
    if cfg is None:
        with torch.no_grad():
            fp0 = setup_face_planes(meshes, cam)
        cfg = cuda_soft.suggest_soft_config(fp0, size, sigma=sigma,
                                            layout="packed")

    def grad(v):
        v = v.detach().requires_grad_(True)
        fp = setup_face_planes(meshes.update_padded(v), cam)
        alpha = cuda_soft.soft_silhouette_fd(fp, size, sigma=sigma,
                                             check_budgets="off",
                                             **cfg.kwargs())
        (g,) = torch.autograd.grad(alpha.sum(), v)
        return g

    if capture is False:
        def step(v):
            g = grad(v)
            return v.detach() - 1e-6 * g, g

        return step, cfg

    buf = meshes.verts.detach().clone()

    def body():
        g = grad(buf)
        buf.copy_(buf - 1e-6 * g)
        return g

    graph = StepGraph(body, buf.device, capture)

    def step(v):
        if v is not buf:
            buf.copy_(v)
        return buf, graph()

    return step, cfg


def sharded_scene(batch: int, image: int, level: int, device, device_mesh):
    """This rank's part of the multi-card bench: the scene of batch views
    per card (the whole batch x the 'data' axis size), sized once on the
    whole batch's projection, so every rank sizes alike, and cut to this
    rank's slice. Returns (meshes, cam, cfg)."""
    from .parallel.mesh import DATA_AXIS, axis_size, shard_batch

    cards = axis_size(device_mesh, DATA_AXIS)
    meshes, cam = scene(batch * cards, image, level, device)
    with torch.no_grad():
        fp0 = setup_face_planes(meshes, cam)
    cfg = cuda_soft.suggest_soft_config(fp0, cam.image_size, sigma=SIGMA,
                                        layout="packed")
    meshes, cam = shard_batch((meshes, cam), device_mesh)
    return meshes, cam, cfg


def time_passes(step, v, batch: int, steps: int, warmup: int,
                passes: int):
    """img/s of each pass (warmup steps, then `steps` timed ones: CUDA
    events on the card, the host clock on the CPU) and the last v."""
    cuda = v.is_cuda
    rates = []
    for _ in range(passes):
        for _ in range(warmup):
            v, _ = step(v)
        if cuda:
            torch.cuda.synchronize(v.device)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(steps):
            v, _ = step(v)
        if cuda:
            stop.record()
            torch.cuda.synchronize(v.device)
            seconds = start.elapsed_time(stop) / 1e3
        else:
            seconds = time.perf_counter() - t0
        rates.append(batch * steps / seconds)
    return rates, v


def _counters() -> dict:
    """The step's wrappers' launch counters (launches from the host: eager
    calls, warm-ups and captures; a replay counts nothing)."""
    counts = timing.counters()
    return {k: counts[k] for k in ("soft_coverage_fwd", "soft_coverage_bwd",
                                   "gather_tiles_fwd", "gather_tiles_bwd")}


# the device kernels of the step's wrappers, by the names a profiler reads
DEVICE_NAMES = {"soft_coverage_fwd": "soft_coverage_fwd_kernel",
                "soft_coverage_bwd": "soft_coverage_bwd_kernel",
                "gather_tiles_fwd": "gather_fwd_kernel",
                "gather_tiles_bwd": "gather_bwd_kernel"}


def launches_per_step(step, v) -> dict:
    """The port's kernels launched by one step, by their wrappers' counts
    (an eager step's: a replay of a captured step advances none), and on
    the card, by torch.profiler, every kernel the step puts on the device
    and those of the port's kernels by name (None on the CPU)."""
    before = _counters()
    step(v)
    ours = {k: n - before[k] for k, n in _counters().items()}
    if not v.is_cuda:
        return {"kernels": ours, "device_kernels": None,
                "device_by_name": None}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(v.device)
    for _ in range(3):    # a window may record no device event: again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(v)
            torch.cuda.synchronize(v.device)
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    return {"kernels": ours, "device_kernels": len(names),
            "device_by_name": {k: sum(n in e for e in names)
                               for k, n in DEVICE_NAMES.items()}}


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "no card (nvidia-smi unavailable)"
    return out.stdout.strip().splitlines()[0]


def _cpu_fps():
    try:
        return json.loads(BASELINE.read_text())["cpu_fps"]
    except (OSError, ValueError, KeyError):
        return None


def _card_rank(p: dict, eager: bool) -> dict:
    """One rank of the multi-card bench: its passes over its slice."""
    from .parallel.mesh import data_mesh

    device = resolve_device(None)
    meshes, cam, cfg = sharded_scene(p["batch"], p["image"], p["level"],
                                     device, data_mesh())
    step, _ = make_step(meshes, cam, cfg=cfg,
                        capture=False if eager else None)
    rates, v = time_passes(step, meshes.verts, p["batch"], p["steps"],
                           p["warmup"], p["passes"])
    return {"rates": rates, "finite": bool(torch.isfinite(v).all()),
            "card": torch.cuda.get_device_name(device)}


def _main_cards(args, p: dict, cards: int) -> dict:
    """The weak-scaling run over ``cards`` ranks, one card each."""
    from .parallel.launch import run_ranks

    print(card_line(), flush=True)
    ranks = run_ranks(_card_rank, cards, None, p, args.eager)
    if not all(r["finite"] for r in ranks):
        raise RuntimeError("the chained steps gave non-finite vertices")
    form = "eager" if args.eager else "captured CUDA graph"
    print(f"scene: B={p['batch']} per card x {cards} cards, "
          f"{p['image']}x{p['image']}, step: {form} on every rank",
          flush=True)
    for i, r in enumerate(ranks):
        print(f"rank {i} ({r['card']}) passes (CUDA events, {p['steps']} "
              f"steps after {p['warmup']}): "
              + ", ".join(f"{x:.1f}" for x in r["rates"]) + " img/s",
              flush=True)
    medians = [statistics.median(r["rates"]) for r in ranks]
    value = sum(medians) / cards
    print(f"{sum(medians):.1f} img/s over {cards} cards = {value:.1f} "
          "img/s per card", flush=True)
    cpu_fps = None if args.quick else _cpu_fps()
    record = {"metric": METRIC, "value": round(value, 2),
              "unit": "images/s",
              "vs_baseline": round(value / cpu_fps, 2) if cpu_fps else None,
              "n_chips": cards}
    print(json.dumps(record), flush=True)
    return {**record, "ranks": ranks, "step": form}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="B=2, 128x128, level 2, 5 steps")
    ap.add_argument("--device", default=None,
                    help="default: the current card (cpu to run there)")
    ap.add_argument("--eager", action="store_true",
                    help="launch each step's kernels from the host (default: "
                         "replay the step as a captured CUDA graph on the "
                         "card; the CPU runs eagerly either way)")
    ap.add_argument("--cards", type=int, default=None,
                    help="one rank a card over this many cards (default: "
                         "every visible card; 1 on the CPU)")
    args = ap.parse_args(argv)
    p = QUICK if args.quick else FULL
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    cards = args.cards or (torch.cuda.device_count() if on_card else 1)
    if cards > 1:
        if not on_card:
            raise ValueError("--cards > 1 needs the cards")
        return _main_cards(args, p, cards)
    print(card_line() if on_card else f"device: {device} (no card timing)",
          flush=True)

    meshes, cam = scene(p["batch"], p["image"], p["level"], device)
    step, cfg = make_step(meshes, cam, capture=False if args.eager else None)
    form = "eager" if args.eager or not on_card else "captured CUDA graph"
    print(f"scene: B={p['batch']}, {p['image']}x{p['image']}, "
          f"{meshes.max_faces} faces, sigma {SIGMA}; config {cfg}; step: "
          f"{form}", flush=True)
    rates, v = time_passes(step, meshes.verts, p["batch"], p["steps"],
                           p["warmup"], p["passes"])
    if not bool(torch.isfinite(v).all()):
        raise RuntimeError("the chained steps gave non-finite vertices")
    clock = "CUDA events" if on_card else "host clock"
    print(f"passes ({clock}, {p['steps']} steps after {p['warmup']}): "
          + ", ".join(f"{r:.1f}" for r in rates) + " img/s", flush=True)
    value = statistics.median(rates)
    print(f"median {value:.1f} img/s, spread {min(rates):.1f}-"
          f"{max(rates):.1f}", flush=True)
    launches = launches_per_step(step, v)
    print(f"launches per step: {launches}", flush=True)
    cpu_fps = None if args.quick else _cpu_fps()
    record = {"metric": METRIC, "value": round(value, 2),
              "unit": "images/s",
              "vs_baseline": round(value / cpu_fps, 2) if cpu_fps else None,
              "n_chips": 1}
    print(json.dumps(record), flush=True)
    return {**record, "passes": rates, "launches": launches,
            "config": cfg._asdict(), "step": form}


if __name__ == "__main__":
    main()

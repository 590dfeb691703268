"""Smoke run of the PyTorch + CUDA port's main path on one NVIDIA GPU.

Drives the soft-silhouette render + backward at the bench's full scale
(B=8, 256x256, a level-3 icosphere of 1280 faces, sigma=1e-4) through the
port's public entry points, and checks it:

  1. a CUDA card is present (there is no CPU fallback); prints its name and
     power limit;
  2. builds the hand-written kernels from the sources in this checkout;
  3. holds each kernel against its plain PyTorch version on the card, at
     the shapes the main path gives it;
  4. holds step 0's alpha against the dense streaming oracle;
  5. runs 100 chained render + grad steps (v <- v - 1e-6 * grad), checks the
     gradients and that every step launched each kernel exactly once, and
     times the steps with CUDA events.

Any failure raises (exit code 1). The second-to-last line is a JSON record
of the kernels; the last line is {"ok": true, "device": {...}}.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

B = 8
IMAGE = 256
LEVEL = 3            # 1280 faces
SIGMA = 1e-4
STEPS = 100
WARMUP = 10
TIMING_REPS = 20     # launches per kernel timing


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = TIMING_REPS) -> float:
    """Mean device time of fn() over reps calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bench_scene(device):
    """The bench scene (bench.py's _scene): icosphere at t = (0, 0, 3) seen
    with f = 0.8 * IMAGE, replicated B times."""
    import torch_renderer_tpu_torch as trt

    verts, faces = trt.icosphere(LEVEL)
    f = 0.8 * IMAGE
    K = np.array([[f, 0, IMAGE / 2.0], [0, f, IMAGE / 2.0], [0, 0, 1.0]],
                 np.float32)
    t = np.tile(np.array([0.0, 0.0, 3.0], np.float32), (B, 1))
    meshes = trt.Meshes.from_single(verts, faces, device=device).extend(B)
    cam = trt.PerspectiveCamera.from_K(np.tile(K[None], (B, 1, 1)),
                                       (IMAGE, IMAGE), t=t, device=device)
    return meshes, cam


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible; this script "
                         "only runs on a GPU")
    # a reference states its float32 matmul and convolution precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import torch_renderer_tpu_torch as trt
    from torch_renderer_tpu_torch import _build
    from torch_renderer_tpu_torch.rasterize import cuda_soft
    from torch_renderer_tpu_torch.rasterize.binning import bin_faces_active
    from torch_renderer_tpu_torch.rasterize.soft import SOFT_CUTOFF

    device = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_kernels()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s -> {lib_path}", flush=True)
    print((lib_path.parent / "build.log").read_text(), flush=True)

    meshes, cam = bench_scene(device)
    fp0 = trt.setup_face_planes(meshes, cam)
    cfg = trt.suggest_soft_config(fp0, (IMAGE, IMAGE), sigma=SIGMA,
                                  layout="packed")
    print(f"config: {cfg}", flush=True)

    # -- 3. kernels vs their plain versions at the main path's shapes --------
    bins = bin_faces_active(fp0, (IMAGE, IMAGE), cfg.tile,
                            math.sqrt(SOFT_CUTOFF * SIGMA), cfg.active_tiles)
    q, count = cuda_soft.tile_slabs(
        fp0, bins, min(cfg.faces_per_tile, fp0.num_faces))
    tile, inv_s, inv_sigma = cfg.tile, 1.0 / (IMAGE / 2.0), 1.0 / SIGMA
    g = torch.rand((B, q.shape[1], tile * tile), device=device)
    print(f"kernel shapes: q {tuple(q.shape)}, live candidates "
          f"{int(count.sum())}, max per tile {int(count.max())}", flush=True)

    S_k = cuda_soft.soft_coverage_fwd(q, count, tile, inv_s, inv_sigma)
    S_p = cuda_soft.soft_coverage_fwd_reference(q, count, tile, inv_s,
                                                inv_sigma)
    dq_k = cuda_soft.soft_coverage_bwd(q, count, g, tile, inv_s, inv_sigma)
    dq_p = cuda_soft.soft_coverage_bwd_reference(q, count, g, tile, inv_s,
                                                 inv_sigma)
    torch.cuda.synchronize()
    fwd_err = float((S_k - S_p).abs().max())
    fwd_tol = 1e-4 + 1e-5 * float(S_p.abs().max())
    bwd_err = float((dq_k - dq_p).abs().max())
    # the kernel sums pixels in another order and form than the plain version
    bwd_tol = 1e-3 * float(dq_p.abs().max())
    print(f"soft_coverage_fwd vs plain: max|dS| {fwd_err:.3e} "
          f"(tol {fwd_tol:.3e}, max|S| {float(S_p.abs().max()):.3e})",
          flush=True)
    print(f"soft_coverage_bwd vs plain: max|ddq| {bwd_err:.3e} "
          f"(tol {bwd_tol:.3e}, max|dq| {float(dq_p.abs().max()):.3e})",
          flush=True)
    if not fwd_err <= fwd_tol:
        raise AssertionError("soft_coverage_fwd disagrees with its plain "
                             "version")
    if not bwd_err <= bwd_tol:
        raise AssertionError("soft_coverage_bwd disagrees with its plain "
                             "version")

    times = {
        "fwd": time_ms(lambda: cuda_soft.soft_coverage_fwd(
            q, count, tile, inv_s, inv_sigma)),
        "fwd_plain": time_ms(lambda: cuda_soft.soft_coverage_fwd_reference(
            q, count, tile, inv_s, inv_sigma)),
        "bwd": time_ms(lambda: cuda_soft.soft_coverage_bwd(
            q, count, g, tile, inv_s, inv_sigma)),
        "bwd_plain": time_ms(lambda: cuda_soft.soft_coverage_bwd_reference(
            q, count, g, tile, inv_s, inv_sigma)),
    }
    print(f"kernel times at the bench shape ({card}): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()),
          flush=True)

    # -- 4. step 0 against the dense oracle ----------------------------------
    with torch.no_grad():
        alpha0 = trt.soft_silhouette_fd(fp0, (IMAGE, IMAGE), sigma=SIGMA,
                                        **cfg.kwargs())
        dense = trt.soft_silhouette_streaming(meshes, cam, sigma=SIGMA,
                                              pixel_chunk=4096)
    a_err = float((alpha0 - dense).abs().max())
    print(f"step 0: alpha {tuple(alpha0.shape)}, max {float(alpha0.max()):.4f}"
          f", max|alpha - dense oracle| {a_err:.3e} (tol 2e-4)", flush=True)
    if tuple(alpha0.shape) != (B, IMAGE, IMAGE) or not a_err <= 2e-4:
        raise AssertionError("step-0 alpha disagrees with the dense oracle")
    if not float(alpha0.max()) > 0.9:
        raise AssertionError("step-0 alpha covers nothing")

    # -- 5. chained render + grad steps --------------------------------------
    def step(v):
        v = v.detach().requires_grad_(True)
        fp = trt.setup_face_planes(meshes.update_padded(v), cam)
        alpha = trt.soft_silhouette_fd(fp, (IMAGE, IMAGE), sigma=SIGMA,
                                       **cfg.kwargs())
        (grad,) = torch.autograd.grad(alpha.sum(), v)
        return v.detach() - 1e-6 * grad, grad

    cuda_soft.FWD_LAUNCHES = 0
    cuda_soft.BWD_LAUNCHES = 0
    v = meshes.verts
    for i in range(WARMUP):
        v, grad = step(v)
        if not bool(torch.isfinite(grad).all()):
            raise AssertionError(f"non-finite gradient at step {i}")
        if i == 0 and not float(grad.abs().sum()) > 0:
            raise AssertionError("the first gradient is zero")
    torch.cuda.synchronize()
    finite = torch.ones((), dtype=torch.bool, device=device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(STEPS):
        v, grad = step(v)
        finite &= torch.isfinite(grad).all()
    stop.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    step_ms = start.elapsed_time(stop) / STEPS
    run = WARMUP + STEPS
    launches = {"fwd": cuda_soft.FWD_LAUNCHES, "bwd": cuda_soft.BWD_LAUNCHES}
    print(f"main path: {run} steps, launches {launches}", flush=True)
    if not bool(finite) or not bool(torch.isfinite(v).all()):
        raise AssertionError("non-finite gradient in the timed steps")
    if launches != {"fwd": run, "bwd": run}:
        raise AssertionError(f"expected {run} launches of each kernel, got "
                             f"{launches}")
    print(f"main path: {B * 1000.0 / step_ms:.1f} img/s ({step_ms:.4f} ms "
          f"per step of B={B}, CUDA events over {STEPS} steps; host wall "
          f"{wall_s * 1000.0 / STEPS:.4f} ms/step) on {card}; kernel alone "
          f"fwd {times['fwd']:.4f} ms / bwd {times['bwd']:.4f} ms, plain "
          f"alone fwd {times['fwd_plain']:.4f} ms / bwd "
          f"{times['bwd_plain']:.4f} ms; build {build_s:.2f} s", flush=True)

    source = "torch_renderer_tpu_torch/csrc/soft_coverage.cu"
    print(json.dumps({"kernels": [
        {"name": "soft_coverage_fwd", "route": "cuda", "source": source,
         "replaces": "torch_renderer_tpu/rasterize/pallas_soft.py:572",
         "also_replaces": "torch_renderer_tpu/rasterize/pallas_soft.py:132",
         "launches": launches["fwd"], "max_abs_err": fwd_err,
         "ms": times["fwd"], "plain_ms": times["fwd_plain"]},
        {"name": "soft_coverage_bwd", "route": "cuda", "source": source,
         "replaces": "torch_renderer_tpu/rasterize/pallas_soft.py:597",
         "also_replaces": "torch_renderer_tpu/rasterize/pallas_soft.py:161",
         "launches": launches["bwd"], "max_abs_err": bwd_err,
         "ms": times["bwd"], "plain_ms": times["bwd_plain"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

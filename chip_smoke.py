"""Smoke run of the PyTorch + CUDA port's main paths on one NVIDIA GPU.

Drives, through the port's public entry points:

  A. the soft-silhouette render + backward at the bench's full scale (B=8,
     256x256, a level-3 icosphere of 1280 faces, sigma=1e-4): each soft
     kernel against its plain PyTorch version, step 0's alpha against the
     dense streaming oracle, and 100 chained render + grad steps
     (v <- v - 1e-6 * grad) that must launch each kernel once a step;
  B. the hard-raster kernels against their plain versions at the camera
     pose fit's shapes (B=1, 128x128, the level-3 icosphere normalized to
     the unit sphere at look_at(2.7, 15, 40), tile 16, budgets from
     autotune at margin 2.0): hard_k1 at blur 0, topk_select at K=4 with
     blur 9.21e-4 and at K=50 with blur 1e-4. Winners must be identical,
     or differ only at selection-depth ties within 1e-6 on under 0.1% of
     covered pixels; values within 1e-5;
  C. the camera pose fit at the app's defaults (Adam lr 1e-3, 500
     iterations, RGB on, start translation perturbed by 0.1 * N(0, 1) from
     seed 0, budget checks off), through the default fragments route
     (K=4) and the silhouette_impl="pallas" route (soft kernels + K=1).
     Every loss finite, the loss and the translation error below 0.1x their
     start, and per iteration exactly one topk_select launch (fragments),
     or one hard_k1, soft_coverage_fwd and soft_coverage_bwd launch
     (pallas).

Every kernel time and every plain time is taken with CUDA events; the fits
are timed by CUDA events and by host wall time. Any failure raises (exit
code 1). The second-to-last line is a JSON record of the kernels; the last
line is {"ok": true, "device": {...}}.

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

POSE_IMAGE = 128
POSE_ITERS = 500
POSE_BLUR = math.log(1.0 / 1e-4 - 1.0) * SIGMA   # the fragments route's blur
TIE_TOL = 1e-6       # selection-depth gap that counts as a tie
TIE_SHARE = 1e-3     # most covered pixels whose winners may differ by a tie
VALUE_TOL = 1e-5


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


def reset_counts() -> None:
    from torch_renderer_tpu_torch.rasterize import cuda_hard, cuda_soft

    cuda_soft.FWD_LAUNCHES = cuda_soft.BWD_LAUNCHES = 0
    cuda_hard.HARD_LAUNCHES = cuda_hard.TOPK_LAUNCHES = 0


def read_counts() -> dict:
    from torch_renderer_tpu_torch.rasterize import cuda_hard, cuda_soft

    return {"soft_coverage_fwd": cuda_soft.FWD_LAUNCHES,
            "soft_coverage_bwd": cuda_soft.BWD_LAUNCHES,
            "hard_k1": cuda_hard.HARD_LAUNCHES,
            "topk_select": cuda_hard.TOPK_LAUNCHES}


# ---------------------------------------------------------------------------
# A. soft-silhouette render + backward (the bench scene)
# ---------------------------------------------------------------------------

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


def soft_phase(device, card: str) -> list:
    import torch_renderer_tpu_torch as trt
    from torch_renderer_tpu_torch.rasterize import cuda_soft
    from torch_renderer_tpu_torch.rasterize.binning import bin_faces_active
    from torch_renderer_tpu_torch.rasterize.soft import SOFT_CUTOFF

    meshes, cam = bench_scene(device)
    fp0 = trt.setup_face_planes(meshes, cam)
    cfg = trt.suggest_soft_config(fp0, (IMAGE, IMAGE), sigma=SIGMA,
                                  layout="packed")
    print(f"[soft] config: {cfg}", flush=True)

    # kernels vs their plain versions at the main path's shapes
    bins = bin_faces_active(fp0, (IMAGE, IMAGE), cfg.tile,
                            math.sqrt(SOFT_CUTOFF * SIGMA), cfg.active_tiles)
    q, count = cuda_soft.tile_slabs(
        fp0, bins, min(cfg.faces_per_tile, fp0.num_faces))
    tile, inv_s, inv_sigma = cfg.tile, 1.0 / (IMAGE / 2.0), 1.0 / SIGMA
    g = torch.rand((B, q.shape[1], tile * tile), device=device)
    print(f"[soft] kernel shapes: q {tuple(q.shape)}, live candidates "
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
    print(f"[soft] soft_coverage_fwd vs plain: max|dS| {fwd_err:.3e} "
          f"(tol {fwd_tol:.3e}, max|S| {float(S_p.abs().max()):.3e})",
          flush=True)
    print(f"[soft] soft_coverage_bwd vs plain: max|ddq| {bwd_err:.3e} "
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
    print(f"[soft] kernel times at the bench shape ({card}): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()),
          flush=True)

    # step 0 against the dense oracle
    with torch.no_grad():
        alpha0 = trt.soft_silhouette_fd(fp0, (IMAGE, IMAGE), sigma=SIGMA,
                                        **cfg.kwargs())
        dense = trt.soft_silhouette_streaming(meshes, cam, sigma=SIGMA,
                                              pixel_chunk=4096)
    a_err = float((alpha0 - dense).abs().max())
    print(f"[soft] step 0: alpha {tuple(alpha0.shape)}, max "
          f"{float(alpha0.max()):.4f}, max|alpha - dense oracle| "
          f"{a_err:.3e} (tol 2e-4)", flush=True)
    if tuple(alpha0.shape) != (B, IMAGE, IMAGE) or not a_err <= 2e-4:
        raise AssertionError("step-0 alpha disagrees with the dense oracle")
    if not float(alpha0.max()) > 0.9:
        raise AssertionError("step-0 alpha covers nothing")

    # chained render + grad steps
    def step(v):
        v = v.detach().requires_grad_(True)
        fp = trt.setup_face_planes(meshes.update_padded(v), cam)
        alpha = trt.soft_silhouette_fd(fp, (IMAGE, IMAGE), sigma=SIGMA,
                                       **cfg.kwargs())
        (grad,) = torch.autograd.grad(alpha.sum(), v)
        return v.detach() - 1e-6 * grad, grad

    reset_counts()
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
    counts = read_counts()
    step_ms = start.elapsed_time(stop) / STEPS
    run = WARMUP + STEPS
    print(f"[soft] main path: {run} steps, launches {counts}", flush=True)
    if not bool(finite) or not bool(torch.isfinite(v).all()):
        raise AssertionError("non-finite gradient in the timed steps")
    if counts != {"soft_coverage_fwd": run, "soft_coverage_bwd": run,
                  "hard_k1": 0, "topk_select": 0}:
        raise AssertionError(f"expected {run} launches of each soft kernel "
                             f"and none other, got {counts}")
    print(f"[soft] main path: {B * 1000.0 / step_ms:.1f} img/s "
          f"({step_ms:.4f} ms per step of B={B}, CUDA events over {STEPS} "
          f"steps; host wall {wall_s * 1000.0 / STEPS:.4f} ms/step) on "
          f"{card}", flush=True)

    source = "torch_renderer_tpu_torch/csrc/soft_coverage.cu"
    return [
        {"name": "soft_coverage_fwd", "route": "cuda", "source": source,
         "replaces": "torch_renderer_tpu/rasterize/pallas_soft.py:572",
         "also_replaces": "torch_renderer_tpu/rasterize/pallas_soft.py:132",
         "launches": counts["soft_coverage_fwd"], "max_abs_err": fwd_err,
         "ms": times["fwd"], "plain_ms": times["fwd_plain"]},
        {"name": "soft_coverage_bwd", "route": "cuda", "source": source,
         "replaces": "torch_renderer_tpu/rasterize/pallas_soft.py:597",
         "also_replaces": "torch_renderer_tpu/rasterize/pallas_soft.py:161",
         "launches": counts["soft_coverage_bwd"], "max_abs_err": bwd_err,
         "ms": times["bwd"], "plain_ms": times["bwd_plain"]},
    ]


# ---------------------------------------------------------------------------
# B. hard-raster kernels at the pose fit's shapes
# ---------------------------------------------------------------------------

def pose_scene(device):
    """The app's default scene: meshes, K, R_gt, t_gt and the perturbed
    start translation t0 (numpy)."""
    from torch_renderer_tpu_torch.apps.camera_pose_optimizer import pinhole_K
    from torch_renderer_tpu_torch.cameras.look_at import (
        look_at_view_transform,
    )
    from torch_renderer_tpu_torch.ops.icosphere import icosphere
    from torch_renderer_tpu_torch.structures.meshes import Meshes

    meshes = Meshes.from_single(*icosphere(LEVEL), device=device)
    meshes, _, _ = meshes.center_and_scale_to_unit_sphere()
    K = pinhole_K((POSE_IMAGE, POSE_IMAGE))
    R_gt, t_gt = look_at_view_transform(2.7, 15.0, 40.0)
    R_gt, t_gt = R_gt[0].numpy(), t_gt[0].numpy()
    rng = np.random.default_rng(0)
    t0 = t_gt + 0.1 * rng.standard_normal(3).astype(np.float32)
    return meshes, K, R_gt, t_gt, t0


def _kernel_inputs(meshes, cam, K: int, blur: float):
    """The hard kernels' inputs for this scene, as the raster builds them,
    with budgets resolved by autotune at margin 2.0."""
    from torch_renderer_tpu_torch.rasterize import autotune, cuda_hard
    from torch_renderer_tpu_torch.rasterize.geometry import setup_face_planes
    from torch_renderer_tpu_torch.rasterize.raster import (
        RasterizationSettings,
    )

    st = autotune.resolve_mesh_settings(
        RasterizationSettings((POSE_IMAGE, POSE_IMAGE), blur_radius=blur,
                              faces_per_pixel=K, check_budgets="off"),
        meshes, cam, margin=2.0)
    inp = cuda_hard.binned_inputs(setup_face_planes(meshes, cam), st)
    return st, inp.slab, inp.count, inp.origin


def _winner_check(name, lane_k, lane_p, prio) -> float:
    """Raise unless the kernel's winner slots (B, A, K, P) equal the plain
    version's, or differ only at selection-depth ties on few pixels.
    Returns the largest selection-depth gap between the two (0 when the
    winners are identical)."""
    from torch_renderer_tpu_torch.rasterize.cuda_hard import INF

    def depth(lane):
        z = prio.gather(-1, lane.clamp_min(0).long().transpose(2, 3))
        return torch.where(lane.transpose(2, 3) >= 0, z,
                           torch.full_like(z, INF))

    diff = (lane_k != lane_p).transpose(2, 3)                 # (B, A, P, K)
    covered = int((lane_p[:, :, 0] >= 0).sum())
    n_pix = int(diff.any(-1).sum())
    gap = (depth(lane_k) - depth(lane_p)).abs()
    max_gap = float(gap[diff].max()) if n_pix else 0.0
    print(f"[hard] {name}: {n_pix} of {covered} covered pixels differ in "
          f"a winner, largest selection-depth gap {max_gap:.3e}", flush=True)
    if n_pix and (max_gap > TIE_TOL or n_pix > TIE_SHARE * covered):
        raise AssertionError(f"{name}: winners disagree beyond depth ties")
    return max_gap


def hard_phase(device, card: str) -> dict:
    from torch_renderer_tpu_torch.cameras.perspective import (
        PerspectiveCamera,
    )
    from torch_renderer_tpu_torch.rasterize import autotune, cuda_hard

    meshes, K, R_gt, t_gt, _ = pose_scene(device)
    cam = PerspectiveCamera.from_K(K, (POSE_IMAGE, POSE_IMAGE), R=R_gt,
                                   t=t_gt, device=device)
    out = {}

    # hard_k1 at blur 0 (the pallas route's depth/RGB raster)
    st, slab, count, origin = _kernel_inputs(meshes, cam, 1, 0.0)
    args = (slab, count, origin, st.bin_size, 1.0 / (POSE_IMAGE / 2.0), 0.0,
            st.znear, st.clip_bary)
    print(f"[hard] hard_k1 shapes: slab {tuple(slab.shape)}, live "
          f"candidates {int(count.sum())}, max per tile "
          f"{int(count.max())}", flush=True)
    o_k = cuda_hard.hard_k1(*args)
    o_p = cuda_hard.hard_k1_reference(*args)
    torch.cuda.synchronize()
    prio = cuda_hard._priority(slab, count, origin, *args[3:7])

    def lanes(o):
        lane = torch.where(o[:, :, 6] > 0, o[:, :, 7], -1.0)
        return lane.round().to(torch.int32)[:, :, None]

    gap = _winner_check("hard_k1", lanes(o_k), lanes(o_p), prio)
    same = (lanes(o_k) == lanes(o_p))                         # (B, A, 1, P)
    err = float(((o_k - o_p).abs() * same).max())
    print(f"[hard] hard_k1 vs plain: max|d value| {err:.3e} at equal "
          f"winners (tol {VALUE_TOL:.0e})", flush=True)
    if not err <= VALUE_TOL:
        raise AssertionError("hard_k1 values disagree with its plain version")
    out["hard_k1"] = {
        "max_abs_err": max(err, gap),
        "ms": time_ms(lambda: cuda_hard.hard_k1(*args)),
        "plain_ms": time_ms(lambda: cuda_hard.hard_k1_reference(*args)),
        "shape": list(slab.shape)}

    # topk_select at the fragments route's K=4 / blur, and at K=50
    for Kf, blur in ((4, POSE_BLUR), (50, 1e-4)):
        st, slab, count, origin = _kernel_inputs(meshes, cam, Kf, blur)
        args = (slab, count, origin, Kf, st.bin_size,
                1.0 / (POSE_IMAGE / 2.0), blur, st.znear)
        print(f"[hard] topk_select K={Kf} blur {blur:.3e} shapes: slab "
              f"{tuple(slab.shape)}, max per tile {int(count.max())}",
              flush=True)
        l_k = cuda_hard.topk_select(*args)
        l_p = cuda_hard.topk_select_reference(*args)
        torch.cuda.synchronize()
        prio = cuda_hard._priority(slab, count, origin, *args[4:8])
        gap = _winner_check(f"topk_select K={Kf}", l_k, l_p, prio)
        out[f"topk_select_k{Kf}"] = {
            "max_abs_err": gap,
            "ms": time_ms(lambda: cuda_hard.topk_select(*args)),
            "plain_ms": time_ms(
                lambda: cuda_hard.topk_select_reference(*args)),
            "shape": list(slab.shape)}
    for name, r in out.items():
        print(f"[hard] {name} at {r['shape']} ({card}): kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms", flush=True)
    autotune.clear_cache()   # the fits below resolve their own budgets
    return out


# ---------------------------------------------------------------------------
# C. the camera pose fit, both routes
# ---------------------------------------------------------------------------

def pose_fit_phase(device, card: str, route: str,
                   iters: int = POSE_ITERS) -> dict:
    from torch_renderer_tpu_torch.cameras.perspective import (
        PerspectiveCamera,
    )
    from torch_renderer_tpu_torch.opt.pose_fit import (
        CameraPoseFitter,
        PoseFitConfig,
        pose_params_from_Rt,
        pose_params_to_Rt,
    )
    from torch_renderer_tpu_torch.rasterize.binning import (
        set_budget_check_default,
        suggest_active_tiles_fd,
        tile_grid,
    )
    from torch_renderer_tpu_torch.rasterize.geometry import setup_faces

    set_budget_check_default("off")
    meshes, K, R_gt, t_gt, t0 = pose_scene(device)
    size = (POSE_IMAGE, POSE_IMAGE)
    kw = {}
    if route == "pallas":
        # the app's auto active-tile budget for the silhouette, sized from
        # the GT and start poses with 2x margin (None when all tiles fit)
        with torch.no_grad():
            fds = [setup_faces(meshes, PerspectiveCamera.from_K(
                K, size, R=R_gt, t=t, device=device)) for t in (t_gt, t0)]
        act = max(suggest_active_tiles_fd(fd, size, 16, 0.0, margin=2.0)
                  for fd in fds)
        TH, TW, _ = tile_grid(size, 16)
        kw["sil_active_tiles"] = act if act < TH * TW else None
    fitter = CameraPoseFitter(K, (POSE_IMAGE, POSE_IMAGE),
                              PoseFitConfig(n_steps=iters),
                              silhouette_impl=route, device=device, **kw)
    refs = fitter.make_references(meshes, R_gt, t_gt)
    params0 = pose_params_from_Rt(R_gt, t0, device)

    torch.cuda.synchronize()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t_start = time.perf_counter()
    start.record()
    params, hist = fitter.fit(meshes, refs, params0)
    stop.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t_start
    counts = read_counts()
    events_s = start.elapsed_time(stop) / 1000.0

    loss = hist["loss"].cpu().numpy()
    iou = hist["iou"].cpu().numpy()
    err0 = float(np.linalg.norm(t0 - t_gt))
    err1 = float(np.linalg.norm(pose_params_to_Rt(params)[1][0].cpu().numpy()
                                - t_gt))
    print(f"[fit {route}] {fitter.renderer.resolved_settings(meshes, R_gt, t_gt)}",
          flush=True)
    print(f"[fit {route}] loss {loss[0]:.5f} -> {loss[-1]:.5f}, iou "
          f"{iou[0]:.3f} -> {iou[-1]:.3f}, translation error {err0:.4f} -> "
          f"{err1:.4f} m, launches {counts}", flush=True)
    print(f"[fit {route}] {iters} iters: {iters / events_s:.1f} it/s by "
          f"CUDA events ({events_s * 1000.0 / iters:.4f} ms/iter), "
          f"{iters / wall_s:.1f} it/s by host wall time "
          f"({wall_s * 1000.0 / iters:.4f} ms/iter) on {card}", flush=True)
    if not np.isfinite(loss).all() or loss.shape != (iters,):
        raise AssertionError(f"{route}: a loss is not finite")
    if not loss[-1] < 0.1 * loss[0]:
        raise AssertionError(f"{route}: the loss did not fall below 0.1x "
                             "its start")
    if not err1 < 0.1 * err0:
        raise AssertionError(f"{route}: the translation error did not fall "
                             "below 0.1x its start")
    want = ({"topk_select": iters} if route == "fragments" else
            {"hard_k1": iters, "soft_coverage_fwd": iters,
             "soft_coverage_bwd": iters})
    want = {k: want.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{route}: expected launches {want}, got "
                             f"{counts}")
    return {"counts": counts, "it_s_events": iters / events_s,
            "it_s_wall": iters / wall_s, "loss": [float(loss[0]),
                                                   float(loss[-1])],
            "err": [err0, err1]}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible; this script "
                         "only runs on a GPU")
    # a reference states its float32 matmul and convolution precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from torch_renderer_tpu_torch import _build

    device = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_kernels()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s -> {lib_path}", flush=True)
    print((lib_path.parent / "build.log").read_text(), flush=True)

    kernels = soft_phase(device, card)
    hard = hard_phase(device, card)
    fits = {route: pose_fit_phase(device, card, route)
            for route in ("fragments", "pallas")}

    source = "torch_renderer_tpu_torch/csrc/hard_raster.cu"
    k4, k50 = hard["topk_select_k4"], hard["topk_select_k50"]
    kernels += [
        {"name": "hard_k1", "route": "cuda", "source": source,
         "replaces": "torch_renderer_tpu/rasterize/pallas_hard.py:157",
         "also_replaces": "torch_renderer_tpu/rasterize/pallas_hard.py:611",
         "launches": fits["pallas"]["counts"]["hard_k1"],
         "max_abs_err": hard["hard_k1"]["max_abs_err"],
         "ms": hard["hard_k1"]["ms"], "plain_ms": hard["hard_k1"]["plain_ms"]},
        {"name": "topk_select", "route": "cuda", "source": source,
         "replaces": "torch_renderer_tpu/rasterize/pallas_hard.py:237",
         "launches": fits["fragments"]["counts"]["topk_select"],
         "max_abs_err": max(k4["max_abs_err"], k50["max_abs_err"]),
         "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "k50_ms": k50["ms"], "k50_plain_ms": k50["plain_ms"]},
    ]
    print(f"pose fit it/s ({card}): " + ", ".join(
        f"{r} {f['it_s_events']:.1f} (events) / {f['it_s_wall']:.1f} (wall)"
        for r, f in fits.items()), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

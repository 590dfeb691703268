"""Smoke run of the PyTorch + CUDA port's main paths on one NVIDIA GPU.

Drives, through the port's public entry points:

  A. the soft-silhouette render + backward at the bench's full scale (B=8,
     256x256, a level-3 icosphere of 1280 faces, sigma=1e-4): each soft
     kernel against its plain PyTorch version, step 0's alpha against the
     dense streaming oracle, the tile-gather pair against its plain
     versions at the step's corner slab, and the step of the port's bench
     (torch_renderer_tpu_torch/bench.py: v <- v - 1e-6 * grad), whose
     first pass of 10 + 100 steps must launch each soft kernel and each
     gather kernel once a step; the bench's 5 passes give the median img/s
     and its spread, and one profiled step its launches; then a
     torch.profiler window of 20 steps (device ms per step, the top
     kernels, the soft kernels' share); then the packed layout's occupancy
     split there: a forced split that drops nothing (alpha within 1e-6 of
     the unsplit route's, gradients within 1e-5 of their largest, the same
     launches) and the split suggest_soft_config(split=True) sizes (alpha
     within 2e-4 of the dense oracle, the same launches);
  B. the hard-raster kernels against their plain versions at the camera
     pose fit's shapes (B=1, 128x128, the level-3 icosphere normalized to
     the unit sphere at look_at(2.7, 15, 40), tile 16, budgets from
     autotune at margin 2.0): hard_k1 at blur 0, topk_select at K=4 with
     blur 9.21e-4 and at K=50 with blur 1e-4. Winners must be identical,
     or differ only at selection-depth ties within 1e-6 on under 0.1% of
     covered pixels (the count of differing pixels is reported); values
     within 1e-5, and hard_k1's 8 rows equal to plain bit for bit;
     gather_tiles_fwd at the fits' three slabs (the pallas route's K=1
     hard slab and the fragments route's K=4 one, 13 channels, and the
     pallas route's silhouette slab, 6) equal to plain, gather_tiles_bwd at
     the silhouette slab, and both kernels' launch floor (their time on a
     one-slot input; the backward's also with every kernel its wrapper
     launches); untile_scatter on the K=4 raster's four fields in one
     launch, the shape the fits launch it at, equal to its plain version;
     and the soft kernel pair against its plain versions at the pallas
     route's silhouette slab (lane layout, tile 16, every tile active);
  C. the camera pose fit at the app's defaults (Adam lr 1e-3, 500
     iterations, RGB on, start translation perturbed by 0.1 * N(0, 1) from
     seed 0, budget checks off), through the default fragments route
     (K=4) and the silhouette_impl="pallas" route (soft kernels + K=1).
     Every loss finite, the loss and the translation error below 0.1x their
     start, and per iteration exactly one topk_select and one
     gather_tiles_fwd launch (fragments), or one hard_k1, soft_coverage_fwd,
     soft_coverage_bwd and gather_tiles_bwd launch and two gather_tiles_fwd
     launches (pallas); either route also one untile_scatter launch, for
     the four fragment fields of its mesh raster. Then a 20-iteration
     profile of each route (device ms per iteration; topk_select's share,
     or hard_k1's and the soft pair's; the forward gather's).
  D. the texture-sampling kernels against their plain versions at the joint
     fit's shapes: one 256x256x3 map shared by 2 views (batch stride 0),
     32768 points per view at u, v uniform in [0, 1] from a seeded
     generator. Forward within 1e-6; d_wy and d_wx within 1e-5 of their
     largest; d_maps within 1e-5 of its largest (float32 atomics sum a
     texel in an order that changes from run to run); one launch per
     wrapper call. grid_sample (bilinear, border, align_corners) computes
     the same function and is timed beside them as the library yardstick,
     forward and backward. Each time by events and alone (the backward's
     also with every kernel its wrapper launches); the host cost of a call
     is the difference, and the wrappers' host parts (operand check,
     allocation, launch) and grid_sample's call are timed by the host
     clock. Phase E holds the pair at a second shape, its own fragments.
  E. the joint shape + UV-texture fit at the app's defaults: 128x128, a
     level-4 icosphere (5120 faces) with sphere UVs fitted to the same
     sphere scaled by (1, 0.7, 0.9) with the app's striped 128x128 texture,
     15 views, 2 per step, K=8, shade_k 2, a 256x256x3 texture map, budgets
     auto-sized at 1.5x (budget checks off), 500 iterations. Every loss
     finite; the mean silhouette and RGB MSE of the last 20 steps below
     0.7x those of the first 20; max |deform| < 0.5 and the chamfer
     distance to the target (2000 points each, fixed generator) below 0.5x
     its start (the JAX package's tests/test_deform_color.py gates); per
     iteration exactly one texsample_fwd, texsample_bwd, topk_select and
     gather_tiles_fwd and untile_scatter launch and no other.
     Then topk_select at the fit's K=8 shapes against its plain version;
     the texture pair as phase D holds it, at the operands and the
     cotangent (from autograd) that the sampler sees in one loss of the
     fitted mesh on views 0 and 1 (P = 128 x 128 x shade_k 2 a view, empty
     fragments included); and a torch.profiler window of 20 iterations
     (device busy share, kernels per iteration, topk_select's and the
     texture pair's device ms, and those of the kernels the pair's
     backward brings: the zero fill inside TexSampleBackward and the sum
     over the views in the shared map's ExpandBackward).
  F. the point stack at the JAX package's point bench scene
     (scripts/bench_points.py): B=4 clouds of 20000 points (0.8 * N(0, 1)
     from numpy seed 0, uniform [0, 1) RGB), 256x256, f = 0.8 * 256, R = I,
     t = (0, 0, 2.5), radius 0.01, K=8, tile 16, budgets from
     suggest_points_per_bin (margin 1.3) and suggest_active_tiles_points,
     the sphere renderer's sized against its NDC selection radii.
     points_select against its plain version on the scene's uniform-radius
     slab and on the sphere renderer's per-point-radius slab: winners
     identical. The binned alpha fragments against the dense path on the
     card: point ids identical except on pixels where some point's d^2 lies
     within 1e-6 of r^2 (the two paths compute d^2 in other forms), on at
     most 0.1% of covered pixels; zbuf and dists2 within 1e-6 where the ids
     agree. Then 20 forward renders and 20 grad steps (the gradient of
     sum(render^2) with respect to the points) of each renderer: alpha
     auto-resolved, alpha with explicit budgets and active tiles, norm,
     Pulsar splat, Pulsar sphere with active tiles, depth. Every output and
     gradient finite; each render launches points_select and
     gather_tiles_fwd exactly once, a grad step no more, and no other kernel
     runs. A 20-step profile of the alpha grad step, and the peak device
     memory.
  G. the batched multi-view depth render: apps/batch_render_bench.main() at
     its defaults (120 look-at views of a normalized level-3 icosphere at
     1280x720, calls of 12 views, f = 0.9 * 720, bin 32, auto budgets,
     select_impl "affine", --check-budgets warn), which must launch per call
     exactly one hard_k1, one gather_tiles_fwd and one untile_scatter (for
     the four fragment fields) and nothing else. On one 12-view call: the
     launches of that call, the call through the untile kernel against the
     same call ending with the kernel's plain version, bit for bit (depth,
     silhouette and the four fields), gather_tiles_fwd and hard_k1 against
     their plain versions on the call's (12, A, Fmax, 13) slab (each equal;
     hard_k1 with its bound) and untile_scatter on its four fields in one
     launch (each equal), the call timed with either epilogue in turns, a
     20-call profile and the peak device memory; and the untile
     backward (K=4 blur fragments and the silhouette's vertex gradient at
     96^2, bin 16), the kernel's wrapper against the plain epilogue
     differentiated by autograd: fragments equal, gradients within 1e-5 of
     the largest (float32 atomics downstream sum in a run-varying order).

Every kernel time and every plain time is taken with CUDA events; the fits
are timed by CUDA events and by host wall time. Each kernel's bound is the
larger of its bytes (inputs read once, outputs written once, live
candidates only) at 3.35 TB/s and its operations at the float32 peak of 67
TFLOP/s (NVIDIA's H100 SXM data sheet), counted per (pixel, candidate) pair
or per point as the OPS constants below say; the gather pair and the untile
kernel are copies, bound by bytes alone. The hard kernels' operations count
the full priority only for pairs whose pixel lies in the face's bounding
box grown by sqrt(blur) (the pairs it can cover) and a box test for every
other live pair; points_select's count its coverage test only for pairs
whose pixel lies in the splat's box x +- r, y +- r, and a box test for
the rest. The soft forward's count the full pair only where its
term is not exactly +0.0, the edge math alone where it is and the pixel
lies in the face's box grown by sqrt(104 sigma), and a box test for every
other live pair. Their every-pair count, as the plain versions evaluate
it, is reported beside it as bound_every_pair_ms. A library yardstick is
one PyTorch call computing the same function where there is one:
grid_sample for the texture pair, Tensor.gather plus the mask and
scatter_add_ for the gather pair, one torch.take per field for the untile
kernel; each is timed by events and alone (the profiler's sum of every
kernel of the call). Any failure raises (exit code 1). The second-to-last
line is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}.

The build's -Xptxas -v report is printed in full, and the registers,
shared memory and spills of the soft pair, hard_k1_kernel,
topk_select_kernel, points_select_kernel, the gather pair, untile_kernel
and the texture pair's instances once more in a line each.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
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
PASSES = 5           # the bench's passes (torch_renderer_tpu_torch/bench.py)
TIMING_REPS = 20     # launches per kernel timing

POSE_IMAGE = 128
POSE_ITERS = 500
POSE_BLUR = math.log(1.0 / 1e-4 - 1.0) * SIGMA   # the fragments route's blur
TIE_TOL = 1e-6       # selection-depth gap that counts as a tie
TIE_SHARE = 1e-3     # most covered pixels whose winners may differ by a tie
VALUE_TOL = 1e-5

TEX_SIZE = 256
TEX_POINTS = 128 * 128 * 2   # pixels x shade_k slots of one joint-fit view
JOINT_IMAGE = 128
JOINT_LEVEL = 4              # 5120 faces
JOINT_ITERS = 500
PROFILE_ITERS = 20

# The card's peaks (H100 SXM data sheet, 700 W): bytes/s and float32 op/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Operations per (pixel, candidate) pair, read off the kernels' arithmetic
# (an exp or log1p counts as one): the soft pair's three clamped edge
# distances, inside test and softplus (forward) or sigmoid and tied-edge
# gradient (backward); hard_k1's inside-only priority at blur 0; top-K's
# priority with the blur band's edge distances.
OPS_SOFT_FWD = 80
OPS_SOFT_BWD = 100
# Of the forward's 80, the softplus and its add to the sum (25 + 1): a pair
# whose x = -signed d2 / sigma lies below SOFT_CUTOFF adds exactly +0.0 and
# needs only the rest, its edge math.
OPS_SOFTPLUS = 26
OPS_SOFT_EDGE = OPS_SOFT_FWD - OPS_SOFTPLUS
SOFT_CUTOFF = -104.0
OPS_HARD_K1 = 35
OPS_TOPK = 80
# A (pixel, candidate) pair whose pixel lies outside the face's grown
# bounding box needs only the box test: two compares per axis.
OPS_BOX = 4
# points_select per (pixel, live candidate) pair: two differences, two
# squares, a sum and two compares (the insertion of the few covering
# candidates is not counted).
OPS_POINTS = 7

POINTS_B = 4
POINTS_N = 20000
POINTS_IMAGE = 256
POINTS_RADIUS = 0.01
POINTS_STEPS = 20
POINTS_MISS = 1e-6   # d^2 within this of r^2: a pixel on a splat's rim


def ops_tex_fwd(C: int) -> int:
    """Operations per point of the texture forward: the two complements,
    then 6 products and 3 sums per channel."""
    return 2 + 9 * C


def ops_tex_bwd(C: int) -> int:
    """Per point: 2 complements and 4 tap weights; per channel 7 each for
    d_wy and d_wx and 4 products and 4 atomic adds for d_maps."""
    return 6 + 22 * C


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take (ms) and what sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(n_bytes), "ops": int(n_ops)}


def _kernel_name(mangled: str) -> str:
    """The kernel's own name in an Itanium-mangled entry point, with its
    integer and bool template arguments (topk_select_kernel<8,true,1024>):
    the last of the length-prefixed names after _Z or _ZN."""
    import re

    m = re.match(r"_ZN?", mangled)
    if not m:
        return mangled
    at, name = m.end(), mangled
    while at < len(mangled) and mangled[at].isdigit():
        d = re.match(r"\d+", mangled[at:]).group()
        at += len(d)
        name = mangled[at:at + int(d)]
        at += int(d)
    args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[at:])
    if args:
        vals = [("true" if v == "1" else "false") if t == "b" else v
                for t, v in re.findall(r"L([ib])(\d+)E", args.group(1))]
        return f"{name}<{','.join(vals)}>"
    return name


def ptxas_report(log: str) -> dict:
    """Registers, shared memory (bytes) and spill stores / loads (bytes) of
    each kernel in nvcc's -Xptxas -v report (build.log), keyed by the
    kernel's name with its template argument (topk_select_kernel<8>)."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _kernel_name(m.group(1))
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(sm.group(1)) if sm else 0
    return out


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


def _device_events(fn, reps: int = TIMING_REPS) -> list:
    """The device events of `reps` calls of fn() in one torch.profiler
    window. A window that records no device event at all (seen on the card
    once or twice a run) is profiled again, up to three windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if events:
            return events
    return []


def device_ms(fn, name: str | None, reps: int = TIMING_REPS):
    """Mean device time per call of fn() of the kernels whose name holds
    `name` (of every kernel in the window with None: a library call's),
    by torch.profiler: the kernels alone, where time_ms also sees the
    host's launch cost when that is the longer. None if the profiler
    records no such kernel."""
    events = _device_events(fn, reps)
    us = [e.time_range.end - e.time_range.start for e in events
          if name is None or name in e.name]
    if not us:
        print(f"device_ms({name}): no such kernel among "
              f"{sorted({e.name for e in events})}", flush=True)
        return None
    return sum(us) / 1e3 / reps


def wrapper_device(fn, reps: int = TIMING_REPS) -> dict:
    """Everything fn() puts on the device, by torch.profiler: device ms
    per call of all its events (a zero fill's too), events per call and
    their names."""
    events = _device_events(fn, reps)
    return {"all_device_ms": sum(e.time_range.end - e.time_range.start
                                 for e in events) / 1e3 / reps,
            "kernels_per_call": len(events) / reps,
            "kernel_names": sorted({_short(e.name) for e in events})}


def _short(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    argument list (its template arguments stay: a fill shows its
    functor)."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:80]


def reset_counts() -> None:
    from torch_renderer_tpu_torch.ops import cuda_texsample
    from torch_renderer_tpu_torch.rasterize import (
        cuda_gather,
        cuda_hard,
        cuda_points,
        cuda_soft,
        cuda_untile,
    )

    cuda_soft.FWD_LAUNCHES = cuda_soft.BWD_LAUNCHES = 0
    cuda_hard.HARD_LAUNCHES = cuda_hard.TOPK_LAUNCHES = 0
    cuda_texsample.FWD_LAUNCHES = cuda_texsample.BWD_LAUNCHES = 0
    cuda_points.POINTS_LAUNCHES = 0
    cuda_gather.GATHER_FWD_LAUNCHES = cuda_gather.GATHER_BWD_LAUNCHES = 0
    cuda_untile.UNTILE_LAUNCHES = 0


def read_counts() -> dict:
    from torch_renderer_tpu_torch.ops import cuda_texsample
    from torch_renderer_tpu_torch.rasterize import (
        cuda_gather,
        cuda_hard,
        cuda_points,
        cuda_soft,
        cuda_untile,
    )

    return {"soft_coverage_fwd": cuda_soft.FWD_LAUNCHES,
            "soft_coverage_bwd": cuda_soft.BWD_LAUNCHES,
            "hard_k1": cuda_hard.HARD_LAUNCHES,
            "topk_select": cuda_hard.TOPK_LAUNCHES,
            "texsample_fwd": cuda_texsample.FWD_LAUNCHES,
            "texsample_bwd": cuda_texsample.BWD_LAUNCHES,
            "points_select": cuda_points.POINTS_LAUNCHES,
            "gather_tiles_fwd": cuda_gather.GATHER_FWD_LAUNCHES,
            "gather_tiles_bwd": cuda_gather.GATHER_BWD_LAUNCHES,
            "untile_scatter": cuda_untile.UNTILE_LAUNCHES}


def only(counts: dict, **want) -> dict:
    """counts with every kernel not in want expected at 0."""
    return {k: want.get(k, 0) for k in counts}


@contextlib.contextmanager
def plain_epilogue():
    """End the binned mesh raster with the untile kernel's plain version
    (differentiated by autograd) in place of the kernel's wrapper: the
    yardstick the kernel's epilogue is held against."""
    from torch_renderer_tpu_torch.rasterize import cuda_hard, cuda_untile

    saved = cuda_hard.untile_scatter_fields
    cuda_hard.untile_scatter_fields = \
        cuda_untile.untile_scatter_fields_reference
    try:
        yield
    finally:
        cuda_hard.untile_scatter_fields = saved


# ---------------------------------------------------------------------------
# The tile-gather pair against its plain version (phases A and G)
# ---------------------------------------------------------------------------

def gather_check(tag: str, idx, table, card: str, bwd: bool) -> dict:
    """gather_tiles_fwd (and with bwd, gather_tiles_bwd on a random
    cotangent) against the plain versions at these inputs: the forward must
    be equal (a copy), the backward within 1e-6 of the largest table
    gradient (float32 atomics add a row's terms in an order that changes
    from run to run). Times by events and by the profiler (the backward
    also with every kernel its wrapper launches); the library yardsticks
    are one Tensor.gather plus the mask (forward) and one
    scatter_add_ (backward) on precomputed indices, by events and by the
    profiler (every kernel of the call: the mask and the zero fill too)."""
    from torch_renderer_tpu_torch.rasterize import cuda_gather as cg

    B, T, S = idx.shape
    F, C = table.shape[1], table.shape[2]
    live = (idx >= 0) & (idx < F)
    n_live = int(live.sum())
    # the table rows this data needs: each distinct live id of each batch
    n_rows = int(torch.unique(
        (torch.arange(B, device=idx.device)[:, None, None] * F + idx)[live]
    ).numel())
    ids = torch.where(live, idx, 0).long().reshape(B, T * S, 1).expand(
        B, T * S, C)
    mask = live.reshape(B, T * S, 1)
    out_k = cg.gather_tiles_fwd(idx, table)
    out_p = cg.gather_tiles_reference(idx, table)
    torch.cuda.synchronize()
    same = bool(torch.equal(out_k, out_p))
    print(f"[gather] {tag}: gather_tiles_fwd at idx {tuple(idx.shape)} "
          f"{idx.dtype}, table {tuple(table.shape)} ({n_live} live slots, "
          f"{n_rows} distinct rows): "
          f"equal to plain: {same}", flush=True)
    if not same:
        raise AssertionError(f"gather_tiles_fwd ({tag}) disagrees with its "
                             "plain version")
    isz = idx.element_size()
    rec = {"shape": [B, T, S, C], "live": n_live, "rows": n_rows,
           "max_abs_err": 0.0,
           "ms": time_ms(lambda: cg.gather_tiles_fwd(idx, table)),
           "device_ms": device_ms(lambda: cg.gather_tiles_fwd(idx, table),
                                  "gather_fwd_kernel"),
           "plain_ms": time_ms(lambda: cg.gather_tiles_reference(idx, table)),
           "library_ms": time_ms(lambda: torch.where(
               mask, table.gather(1, ids), 0.0)),
           "library_device_ms": device_ms(lambda: torch.where(
               mask, table.gather(1, ids), 0.0), None),
           **bound(B * T * S * isz + n_rows * C * 4 + B * T * S * C * 4, 0)}
    if bwd:
        gen = torch.Generator(device=idx.device).manual_seed(5)
        g = torch.randn((B, T, S, C), generator=gen, device=idx.device)
        d_k = cg.gather_tiles_bwd(idx, g, F)
        d_p = cg.gather_tiles_bwd_reference(idx, g, F)
        torch.cuda.synchronize()
        err = float((d_k - d_p).abs().max())
        tol = 1e-6 * float(d_p.abs().max())
        print(f"[gather] {tag}: gather_tiles_bwd vs plain: max|d| {err:.3e} "
              f"(tol {tol:.3e} = 1e-6 x max {float(d_p.abs().max()):.3e})",
              flush=True)
        if not err <= tol:
            raise AssertionError(f"gather_tiles_bwd ({tag}) disagrees with "
                                 "its plain version")
        g_live = torch.where(mask, g.reshape(B, T * S, C), 0.0)
        rec["bwd"] = {
            "max_abs_err": err, "tol": tol,
            "ms": time_ms(lambda: cg.gather_tiles_bwd(idx, g, F)),
            "device_ms": device_ms(lambda: cg.gather_tiles_bwd(idx, g, F),
                                   "gather_bwd_kernel"),
            # every kernel of the wrapper: on trees before the one-launch
            # backward, a zero fill and the kernel
            **wrapper_device(lambda: cg.gather_tiles_bwd(idx, g, F)),
            "plain_ms": time_ms(
                lambda: cg.gather_tiles_bwd_reference(idx, g, F)),
            "library_ms": time_ms(lambda: torch.zeros_like(table).scatter_add_(
                1, ids, g_live)),
            "library_device_ms": device_ms(
                lambda: torch.zeros_like(table).scatter_add_(1, ids, g_live),
                None),
            # the kernel reads g only at live slots
            **bound(B * T * S * isz + n_live * C * 4 + B * F * C * 4, 0)}
    print(f"[gather] {tag} ({card}): {rec}", flush=True)
    return rec


def gather_floor(device, card: str) -> dict:
    """The gather pair's launch floor: each kernel's time on a one-slot
    input (one live id, a 13-channel table), by events and alone; the
    backward's also with everything its wrapper launches."""
    from torch_renderer_tpu_torch.rasterize import cuda_gather as cg

    idx = torch.zeros((1, 1, 1), dtype=torch.int64, device=device)
    table = torch.ones((1, 1, 13), device=device)
    g = torch.ones((1, 1, 1, 13), device=device)
    rec = {"shape": [1, 1, 1, 13],
           "ms": time_ms(lambda: cg.gather_tiles_fwd(idx, table)),
           "device_ms": device_ms(lambda: cg.gather_tiles_fwd(idx, table),
                                  "gather_fwd_kernel"),
           "bwd": {"ms": time_ms(lambda: cg.gather_tiles_bwd(idx, g, 1)),
                   "device_ms": device_ms(
                       lambda: cg.gather_tiles_bwd(idx, g, 1),
                       "gather_bwd_kernel"),
                   **wrapper_device(lambda: cg.gather_tiles_bwd(idx, g, 1))}}
    print(f"[gather] launch floor, one slot ({card}): {rec}", flush=True)
    return rec


# ---------------------------------------------------------------------------
# A. soft-silhouette render + backward (the bench scene)
# ---------------------------------------------------------------------------

def split_checks(meshes, cam, cfg, dense, card: str) -> dict:
    """The packed layout's occupancy split at the bench scene, against the
    unsplit route of cfg: a forced split (hi_tiles the largest multiple of
    8 below half the active tiles, lo_lanes = faces_per_tile, so nothing
    is dropped) gives alpha within 1e-6 of the unsplit alpha and vertex
    gradients within 1e-5 of their largest (float32 atomics of the gather
    backward); one step of each launches the same kernels as often; and
    the split that suggest_soft_config(split=True) sizes there, if any,
    gives alpha within 2e-4 of the dense oracle."""
    import torch_renderer_tpu_torch as trt

    def run(c):
        """alpha, gradient and the launches of one render + backward."""
        v = meshes.verts.clone().requires_grad_(True)
        reset_counts()
        fp = trt.setup_face_planes(meshes.update_padded(v), cam)
        alpha = trt.soft_silhouette_fd(fp, (IMAGE, IMAGE), sigma=SIGMA,
                                       **c.kwargs())
        (g,) = torch.autograd.grad(alpha.sum(), v)
        torch.cuda.synchronize()
        return alpha.detach(), g, read_counts()

    hi = cfg.active_tiles // 16 * 8
    forced = cfg._replace(hi_tiles=hi, lo_lanes=cfg.faces_per_tile)
    a0, g0, n0 = run(cfg)
    a1, g1, n1 = run(forced)
    a_err = float((a1 - a0).abs().max())
    g_err = float((g1 - g0).abs().max())
    g_tol = 1e-5 * float(g0.abs().max())
    print(f"[soft] forced split (hi_tiles {hi}, lo_lanes "
          f"{forced.lo_lanes}): max|alpha - unsplit| {a_err:.3e} (tol "
          f"1e-6), max|grad - unsplit| {g_err:.3e} (tol {g_tol:.3e}); "
          f"launches {n1} (unsplit {n0})", flush=True)
    if not a_err <= 1e-6 or not g_err <= g_tol:
        raise AssertionError("the forced split disagrees with the unsplit "
                             "route")
    if n1 != n0 or n0 != only(n0, soft_coverage_fwd=1, soft_coverage_bwd=1,
                              gather_tiles_fwd=1, gather_tiles_bwd=1):
        raise AssertionError(f"the split route launched {n1}, the unsplit "
                             f"route {n0}")
    with torch.no_grad():
        fp0 = trt.setup_face_planes(meshes, cam)
    sized = trt.suggest_soft_config(fp0, (IMAGE, IMAGE), sigma=SIGMA,
                                    split=True)
    out = {"forced_hi_tiles": hi, "alpha_vs_unsplit": a_err,
           "grad_vs_unsplit": g_err, "grad_tol": g_tol, "launches": n1,
           "suggested": sized._asdict()}
    print(f"[soft] suggest_soft_config(split=True) at the bench scene: "
          f"{sized}", flush=True)
    if sized.hi_tiles is not None:
        a2, g2, n2 = run(sized)
        d_err = float((a2 - dense).abs().max())
        print(f"[soft] suggested split: max|alpha - dense oracle| "
              f"{d_err:.3e} (tol 2e-4), max|alpha - unsplit| "
              f"{float((a2 - a0).abs().max()):.3e}; launches {n2}",
              flush=True)
        if not d_err <= 2e-4 or not bool(torch.isfinite(g2).all()):
            raise AssertionError("the suggested split disagrees with the "
                                 "dense oracle")
        if n2 != n0:
            raise AssertionError(f"the suggested split launched {n2}")
        out.update(suggested_alpha_vs_dense=d_err,
                   suggested_alpha_vs_unsplit=float((a2 - a0).abs().max()))
    print(f"[soft] occupancy split ({card}): {out}", flush=True)
    return out


def soft_fwd_bound(q, count, tile: int, inv_s: float,
                   inv_sigma: float) -> dict:
    """Bound of the soft forward on one slab: the live corners (24 bytes
    each), count and the tile^2 outputs, each moved once; OPS_SOFT_FWD for
    each live (pixel, face) pair whose term is not exactly +0.0 (x at or
    above SOFT_CUTOFF), OPS_SOFT_EDGE for a pair below the cutoff whose
    pixel lies in the face's screen box grown by sqrt(104 sigma), and
    OPS_BOX for every other live pair: its distance from the face exceeds
    that margin, which puts x below the cutoff by the box test alone.
    bound_every_pair_ms charges OPS_SOFT_FWD to every live pair, as the
    plain version evaluates them."""
    from torch_renderer_tpu_torch.rasterize import cuda_soft

    Bq, Aq, _, _ = q.shape
    tp = tile * tile
    signed, _, _, live, _ = cuda_soft._pair_terms(q, count, tile, inv_s)
    full = live & (-signed * inv_sigma >= SOFT_CUTOFF)          # (B,A,P,K)
    del signed
    r = math.sqrt(-SOFT_CUTOFF / inv_sigma)
    xoff, yoff = cuda_soft._pixel_offsets(tile, inv_s, q.device)

    def near(c, off):
        """(B, A, P, K): the pixel's coordinate within the grown span."""
        lo = q[..., c:6:2].amin(-1)[..., None, :] - r
        hi = q[..., c:6:2].amax(-1)[..., None, :] + r
        return (off[:, None] >= lo) & (off[:, None] <= hi)

    edge = live & ~full & near(0, xoff) & near(1, yoff)
    n_live, n_full, n_edge = int(live.sum()) * tp, int(full.sum()), \
        int(edge.sum())
    del full, edge
    n_bytes = int(count.sum()) * 24 + Bq * Aq * 4 + Bq * Aq * tp * 4
    every = bound(n_bytes, n_live * OPS_SOFT_FWD)
    return {**bound(n_bytes, n_full * OPS_SOFT_FWD + n_edge * OPS_SOFT_EDGE
                    + (n_live - n_full - n_edge) * OPS_BOX),
            "pairs": n_live, "full_pairs": n_full, "edge_pairs": n_edge,
            "bound_every_pair_ms": every["bound_ms"],
            "bound_every_pair_by": every["bound_by"]}


def soft_pair_check(tag: str, q, count, tile: int, inv_s: float,
                    inv_sigma: float, card: str) -> dict:
    """The soft kernel pair against its plain versions on one slab: the
    forward within 1e-4 + 1e-5 max|S|, the backward within 1e-3 max|dq| on
    a random cotangent; times by events, by the profiler and the plain
    versions, and each kernel's bound (soft_fwd_bound; OPS_SOFT_BWD per
    live pair)."""
    from torch_renderer_tpu_torch.rasterize import cuda_soft

    Bq, Aq, Kq, _ = q.shape
    tp = tile * tile
    g = torch.rand((Bq, Aq, tp), device=q.device)
    print(f"[soft] {tag}: kernel shapes: q {tuple(q.shape)}, live "
          f"candidates {int(count.sum())}, max per tile {int(count.max())}",
          flush=True)
    args = (q, count, tile, inv_s, inv_sigma)
    S_k = cuda_soft.soft_coverage_fwd(*args)
    S_p = cuda_soft.soft_coverage_fwd_reference(*args)
    dq_k = cuda_soft.soft_coverage_bwd(q, count, g, tile, inv_s, inv_sigma)
    dq_p = cuda_soft.soft_coverage_bwd_reference(q, count, g, tile, inv_s,
                                                 inv_sigma)
    torch.cuda.synchronize()
    fwd_err = float((S_k - S_p).abs().max())
    fwd_tol = 1e-4 + 1e-5 * float(S_p.abs().max())
    bwd_err = float((dq_k - dq_p).abs().max())
    # the kernel sums pixels in another order and form than the plain version
    bwd_tol = 1e-3 * float(dq_p.abs().max())
    print(f"[soft] {tag}: soft_coverage_fwd vs plain: max|dS| "
          f"{fwd_err:.3e} (tol {fwd_tol:.3e}, max|S| "
          f"{float(S_p.abs().max()):.3e})", flush=True)
    print(f"[soft] {tag}: soft_coverage_bwd vs plain: max|ddq| "
          f"{bwd_err:.3e} (tol {bwd_tol:.3e}, max|dq| "
          f"{float(dq_p.abs().max()):.3e})", flush=True)
    if not fwd_err <= fwd_tol:
        raise AssertionError(f"soft_coverage_fwd ({tag}) disagrees with its "
                             "plain version")
    if not bwd_err <= bwd_tol:
        raise AssertionError(f"soft_coverage_bwd ({tag}) disagrees with its "
                             "plain version")
    live = int(count.sum())
    b_fwd = soft_fwd_bound(q, count, tile, inv_s, inv_sigma)
    b_bwd = bound(live * 24 + Bq * Aq * 4 + Bq * Aq * tp * 4
                  + Bq * Aq * Kq * 24, live * tp * OPS_SOFT_BWD)
    fwd = lambda: cuda_soft.soft_coverage_fwd(*args)  # noqa: E731
    bwd = lambda: cuda_soft.soft_coverage_bwd(  # noqa: E731
        q, count, g, tile, inv_s, inv_sigma)
    out = {
        "fwd": {"max_abs_err": fwd_err, "tol": fwd_tol, "ms": time_ms(fwd),
                "device_ms": device_ms(fwd, "soft_coverage_fwd_kernel"),
                "plain_ms": time_ms(
                    lambda: cuda_soft.soft_coverage_fwd_reference(*args)),
                **b_fwd},
        "bwd": {"max_abs_err": bwd_err, "tol": bwd_tol, "ms": time_ms(bwd),
                "device_ms": device_ms(bwd, "soft_coverage_bwd_kernel"),
                "plain_ms": time_ms(
                    lambda: cuda_soft.soft_coverage_bwd_reference(
                        q, count, g, tile, inv_s, inv_sigma)),
                **b_bwd},
        "shape": list(q.shape), "live": live}
    print(f"[soft] {tag}: kernel times ({card}; {live} live candidates x "
          f"{tp} pixels): {out}", flush=True)
    return out


# the soft forward's pair counts and every-pair bound (soft_fwd_bound)
SOFT_FWD_PAIR_KEYS = ("pairs", "full_pairs", "edge_pairs",
                      "bound_every_pair_ms")


def soft_phase(device, card: str):
    import torch_renderer_tpu_torch as trt
    from torch_renderer_tpu_torch import bench
    from torch_renderer_tpu_torch.rasterize import cuda_soft
    from torch_renderer_tpu_torch.rasterize.binning import (
        bin_faces_active,
        slot_faces,
    )
    from torch_renderer_tpu_torch.rasterize.soft import SOFT_CUTOFF

    meshes, cam = bench.scene(B, IMAGE, LEVEL, device)
    fp0 = trt.setup_face_planes(meshes, cam)
    cfg = trt.suggest_soft_config(fp0, (IMAGE, IMAGE), sigma=SIGMA,
                                  layout="packed")
    print(f"[soft] config: {cfg}", flush=True)

    # kernels vs their plain versions at the main path's shapes
    bins = bin_faces_active(fp0, (IMAGE, IMAGE), cfg.tile,
                            math.sqrt(SOFT_CUTOFF * SIGMA), cfg.active_tiles)
    q, count = cuda_soft.tile_slabs(
        fp0, bins, min(cfg.faces_per_tile, fp0.num_faces))
    q = q.detach()
    pair = soft_pair_check("bench slab", q, count, cfg.tile,
                           1.0 / (IMAGE / 2.0), 1.0 / SIGMA, card)

    # the slab gather pair at the bench slab (the step's corner gather)
    idx = slot_faces(bins, q.shape[2], empty=-1)
    corners = torch.stack([fp0.x0, fp0.y0, fp0.x1, fp0.y1, fp0.x2, fp0.y2],
                          dim=-1).contiguous()
    gather = gather_check("soft bench slab", idx, corners, card, bwd=True)

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

    # chained render + grad steps: the step of the port's bench
    # (torch_renderer_tpu_torch/bench.py), sized there as here. The main
    # path is its first pass (WARMUP + STEPS steps), counted; PASSES - 1
    # more give the median and the spread, as the bench reports them.
    step, _ = bench.make_step(meshes, cam, SIGMA, cfg)
    v, grad = step(meshes.verts)
    if not bool(torch.isfinite(grad).all()) or \
            not float(grad.abs().sum()) > 0:
        raise AssertionError("the first gradient is not finite and nonzero")
    reset_counts()
    rates, v = bench.time_passes(step, meshes.verts, B, STEPS, WARMUP, 1)
    counts = read_counts()
    more, v = bench.time_passes(step, v, B, STEPS, WARMUP, PASSES - 1)
    rates += more
    run = WARMUP + STEPS
    print(f"[soft] main path: {run} steps, launches {counts}", flush=True)
    if not bool(torch.isfinite(v).all()):
        raise AssertionError("non-finite vertices after the timed steps")
    if counts != only(counts, soft_coverage_fwd=run, soft_coverage_bwd=run,
                      gather_tiles_fwd=run, gather_tiles_bwd=run):
        raise AssertionError(f"expected {run} launches of each soft and "
                             f"gather kernel and none other, got {counts}")
    img_s = statistics.median(rates)
    per_step = bench.launches_per_step(step, v)
    print(f"[soft] bench passes ({STEPS} steps after {WARMUP}, CUDA "
          f"events, B={B}): " + ", ".join(f"{r:.1f}" for r in rates)
          + f" img/s; median {img_s:.1f}, spread {min(rates):.1f}-"
          f"{max(rates):.1f}; launches per step {per_step} on {card}",
          flush=True)
    prof = _busy_share(lambda: [step(v) for _ in range(PROFILE_ITERS)],
                       PROFILE_ITERS, top=5,
                       named=("soft_coverage_bwd", "soft_coverage_fwd"))
    print(f"[soft] profile over {PROFILE_ITERS} steps ({card}): {prof}",
          flush=True)
    print(f"[soft] soft_coverage_fwd in the step profile: "
          f"{prof['soft_coverage_fwd_ms_per_iter']:.4f} ms per step, "
          f"{100 * prof['soft_coverage_fwd_share_of_busy']:.1f}% of "
          f"{prof['busy_ms_per_iter']:.4f} busy ms ({card})", flush=True)
    split = split_checks(meshes, cam, cfg, dense, card)

    source = "torch_renderer_tpu_torch/csrc/soft_coverage.cu"
    gather["launches_bwd"] = counts["gather_tiles_bwd"]
    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by")
    f, b = pair["fwd"], pair["bwd"]
    fwd_keys = keys + SOFT_FWD_PAIR_KEYS
    return gather, [
        {"name": "soft_coverage_fwd", "route": "cuda", "source": source,
         "replaces": "torch_renderer_tpu/rasterize/pallas_soft.py:572",
         "also_replaces": ["torch_renderer_tpu/rasterize/pallas_soft.py:132",
                           "torch_renderer_tpu/rasterize/pallas_soft.py:342"],
         "launches": counts["soft_coverage_fwd"],
         **{k: f[k] for k in fwd_keys}, "library_ms": None},
        {"name": "soft_coverage_bwd", "route": "cuda", "source": source,
         "replaces": "torch_renderer_tpu/rasterize/pallas_soft.py:597",
         "also_replaces": ["torch_renderer_tpu/rasterize/pallas_soft.py:161",
                           "torch_renderer_tpu/rasterize/pallas_soft.py:362"],
         "launches": counts["soft_coverage_bwd"],
         **{k: b[k] for k in keys}, "library_ms": None,
         "img_s": img_s, "img_s_passes": rates,
         "launches_per_step": per_step, "step_profile": prof,
         "occupancy_split": split},
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
    return st, cuda_hard.binned_inputs(setup_face_planes(meshes, cam), st)


def _winner_check(name, lane_k, lane_p, prio) -> tuple:
    """Raise unless the kernel's winner slots (B, A, K, P) equal the plain
    version's, or differ only at selection-depth ties on few pixels.
    Returns the largest selection-depth gap between the two (0 when the
    winners are identical) and the number of pixels that differ."""
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
    return max_gap, n_pix


def box_pairs(slab, origin, count, tile: int, inv_s: float,
              blur: float) -> int:
    """Live (pixel, candidate) pairs whose pixel lies in the face's screen
    bounding box grown by sqrt(blur): a face covers no pixel outside it
    (inside means inside the box, and the blur band lies within sqrt(blur)
    of an edge), so only these pairs need the face's priority."""
    r = math.sqrt(max(blur, 0.0))
    off = torch.arange(tile, device=slab.device,
                       dtype=torch.float32) * inv_s

    def lines(q, o):
        """(B, A, F) grid lines of the tile within each face's span."""
        g = o[..., None, None] + off                         # (B, A, 1, T)
        lo, hi = q.amin(-1, keepdim=True) - r, q.amax(-1, keepdim=True) + r
        return ((g >= lo) & (g <= hi)).sum(-1)

    live = (torch.arange(slab.shape[2], device=slab.device)
            < count[..., None])
    n = (lines(slab[..., 0:6:2], origin[..., 0])
         * lines(slab[..., 1:6:2], origin[..., 1]))
    return int((n * live).sum())


def hard_bound(slab, count, origin, rows: int, ops_per_pair: int,
               tile: int, inv_s: float, blur: float) -> dict:
    """Bound of a hard kernel: the live slab rows (52 bytes each), count,
    origin and rows x tile^2 outputs of 4 bytes per tile, each moved once;
    ops_per_pair for each live (pixel, candidate) pair whose pixel lies in
    the face's grown box (box_pairs) and OPS_BOX for every other live
    pair. bound_every_pair_ms charges ops_per_pair to every live pair, as
    the plain versions evaluate them."""
    B, A = count.shape
    live, tp = int(count.sum()), tile * tile
    n_bytes = live * 52 + B * A * 12 + B * A * rows * tp * 4
    n_box = box_pairs(slab, origin, count, tile, inv_s, blur)
    every = bound(n_bytes, live * tp * ops_per_pair)
    return {**bound(n_bytes, n_box * ops_per_pair
                    + (live * tp - n_box) * OPS_BOX),
            "box_pairs": n_box, "pairs": live * tp,
            "bound_every_pair_ms": every["bound_ms"],
            "bound_every_pair_by": every["bound_by"]}


def _slab_gather_inputs(inp):
    """The forward gather's inputs of a binned mesh raster
    (cuda_hard.BinnedInputs): each slot's face id (-1 = empty) and the
    (B, F, 13) table of 12 corner channels and the face id, as
    binning.tile_channel_slabs builds them."""
    from torch_renderer_tpu_torch.rasterize.binning import slot_faces

    idx = slot_faces(inp.bins, inp.slab.shape[2], empty=-1)
    B, F = inp.planes.shape[:2]
    fid = torch.arange(F, dtype=torch.float32, device=idx.device)
    return idx, torch.cat([inp.planes.detach(),
                           fid.expand(B, F)[..., None]], dim=-1)


def hard_k1_check(tag: str, inp, st, card: str) -> dict:
    """hard_k1 against its plain version on one binned raster's inputs
    (cuda_hard.BinnedInputs): winners equal or tied, values within
    VALUE_TOL where they agree; times by events, the profiler and the plain
    version, and its bound."""
    from torch_renderer_tpu_torch.rasterize import cuda_hard

    args = (inp.slab, inp.count, inp.origin, st.bin_size, inp.inv_s,
            st.blur_radius, st.znear, st.clip_bary)
    o_k = cuda_hard.hard_k1(*args)
    o_p = cuda_hard.hard_k1_reference(*args)
    torch.cuda.synchronize()

    def lanes(o):
        lane = torch.where(o[:, :, 6] > 0, o[:, :, 7], -1.0)
        return lane.round().to(torch.int32)[:, :, None]

    prio = cuda_hard._priority(*args[:7])
    gap, n_diff = _winner_check(f"hard_k1 ({tag})", lanes(o_k), lanes(o_p),
                                prio)
    del prio
    err = float(((o_k - o_p).abs() * (lanes(o_k) == lanes(o_p))).max())
    same = bool(torch.equal(o_k, o_p))
    print(f"[hard] hard_k1 ({tag}): all 8 rows equal to plain: {same}",
          flush=True)
    if not same:
        raise AssertionError(f"hard_k1 ({tag}) disagrees with its plain "
                             "version")
    rec = {"max_abs_err": max(err, gap), "diff_px": n_diff,
           "shape": list(inp.slab.shape),
           "live": int(inp.count.sum()),
           "ms": time_ms(lambda: cuda_hard.hard_k1(*args)),
           "device_ms": device_ms(lambda: cuda_hard.hard_k1(*args),
                                  "hard_k1_kernel"),
           "plain_ms": time_ms(lambda: cuda_hard.hard_k1_reference(*args),
                               reps=3),
           **hard_bound(inp.slab, inp.count, inp.origin, 8, OPS_HARD_K1,
                        st.bin_size, inp.inv_s, st.blur_radius)}
    print(f"[hard] hard_k1 ({tag}) ({card}): {rec}", flush=True)
    return rec


def hard_phase(device, card: str) -> dict:
    from torch_renderer_tpu_torch.cameras.perspective import (
        PerspectiveCamera,
    )
    from torch_renderer_tpu_torch.rasterize import (
        autotune,
        cuda_hard,
        cuda_soft,
    )
    from torch_renderer_tpu_torch.rasterize.binning import (
        bin_faces_active,
        slot_faces,
        tile_grid,
    )
    from torch_renderer_tpu_torch.rasterize.geometry import setup_face_planes
    from torch_renderer_tpu_torch.rasterize.soft import SOFT_CUTOFF

    meshes, K, R_gt, t_gt, _ = pose_scene(device)
    cam = PerspectiveCamera.from_K(K, (POSE_IMAGE, POSE_IMAGE), R=R_gt,
                                   t=t_gt, device=device)
    out = {}

    # hard_k1 at blur 0 (the pallas route's depth/RGB raster)
    st, inp = _kernel_inputs(meshes, cam, 1, 0.0)
    out["hard_k1"] = hard_k1_check("pose fit", inp, st, card)
    # the forward gather at the fits' hard slabs (12 corner channels and
    # the face id): the pallas route's K=1 and the fragments route's K=4
    gathers = {"pallas_hard": gather_check(
        "pose fit pallas hard slab", *_slab_gather_inputs(inp), card,
        bwd=False)}
    _, inp4 = _kernel_inputs(meshes, cam, 4, POSE_BLUR)
    gathers["fragments"] = gather_check(
        "pose fit fragments slab", *_slab_gather_inputs(inp4), card,
        bwd=False)
    del inp4

    # topk_select at the fragments route's K=4 / blur, and at K=50
    for Kf, blur in ((4, POSE_BLUR), (50, 1e-4)):
        st, inp = _kernel_inputs(meshes, cam, Kf, blur)
        slab, count, origin = inp.slab, inp.count, inp.origin
        args = (slab, count, origin, Kf, st.bin_size, inp.inv_s, blur,
                st.znear)
        print(f"[hard] topk_select K={Kf} blur {blur:.3e} shapes: slab "
              f"{tuple(slab.shape)}, max per tile {int(count.max())}",
              flush=True)
        l_k = cuda_hard.topk_select(*args)
        l_p = cuda_hard.topk_select_reference(*args)
        torch.cuda.synchronize()
        prio = cuda_hard._priority(slab, count, origin, *args[4:8])
        gap, n_diff = _winner_check(f"topk_select K={Kf}", l_k, l_p, prio)
        out[f"topk_select_k{Kf}"] = {
            "max_abs_err": gap, "diff_px": n_diff,
            "ms": time_ms(lambda: cuda_hard.topk_select(*args)),
            "device_ms": device_ms(lambda: cuda_hard.topk_select(*args),
                                   "topk_select"),
            "plain_ms": time_ms(
                lambda: cuda_hard.topk_select_reference(*args)),
            "shape": list(slab.shape),
            **hard_bound(slab, count, origin, Kf, OPS_TOPK, st.bin_size,
                         inp.inv_s, blur)}
    # the untile kernel on the K=4 raster's four fields (the fits' shape)
    st, _ = _kernel_inputs(meshes, cam, 4, POSE_BLUR)
    with torch.no_grad():
        bins, fields = cuda_hard.binned_tile_fields(
            setup_face_planes(meshes, cam), st)
        untile, _ = untile_check("pose fit K=4", bins, fields,
                                 (POSE_IMAGE, POSE_IMAGE), st.bin_size, card)
    del fields
    # the soft pair at the pallas route's silhouette slab: the lane layout,
    # tile 16, 128 faces per tile, every tile active
    fp = setup_face_planes(meshes, cam)
    TH, TW, _ = tile_grid((POSE_IMAGE, POSE_IMAGE), 16)
    sbins = bin_faces_active(fp, (POSE_IMAGE, POSE_IMAGE), 16,
                             math.sqrt(SOFT_CUTOFF * SIGMA), TH * TW)
    q, count = cuda_soft.tile_slabs(fp, sbins, min(128, fp.num_faces))
    soft = soft_pair_check("pose fit (pallas route) slab", q.detach(), count,
                           16, 1.0 / (POSE_IMAGE / 2.0), 1.0 / SIGMA, card)
    # the gather pair at that slab's corner gather
    corners = torch.stack([fp.x0, fp.y0, fp.x1, fp.y1, fp.x2, fp.y2],
                          dim=-1).detach().contiguous()
    gathers["pallas_soft"] = gather_check(
        "pose fit pallas soft slab", slot_faces(sbins, q.shape[2], empty=-1),
        corners, card, bwd=True)
    gathers["floor"] = gather_floor(device, card)
    for name, r in out.items():
        print(f"[hard] {name} at {r['shape']} ({card}): kernel "
              f"{r['ms']:.4f} ms (device {r['device_ms']} ms), plain "
              f"{r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']}: {r['bytes']} B, "
              f"{r['ops']} op; {r['box_pairs']} of {r['pairs']} live pairs "
              f"in a face's box), every-pair bound "
              f"{r['bound_every_pair_ms']:.6f} ms", flush=True)
    autotune.clear_cache()   # the fits below resolve their own budgets
    out["untile"] = untile
    out["soft"] = soft
    out["gathers"] = gathers
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
    # one untile launch per mesh raster: all its fields at once
    want = ({"topk_select": iters, "gather_tiles_fwd": iters,
             "untile_scatter": iters}
            if route == "fragments" else
            {"hard_k1": iters, "soft_coverage_fwd": iters,
             "soft_coverage_bwd": iters, "gather_tiles_fwd": 2 * iters,
             "gather_tiles_bwd": iters, "untile_scatter": iters})
    want = {k: want.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{route}: expected launches {want}, got "
                             f"{counts}")
    prof = _busy_share(lambda: fitter.fit(
        meshes, refs, params, n_steps=PROFILE_ITERS), PROFILE_ITERS,
        top=5, named=(("topk_select",) if route == "fragments" else
                      ("hard_k1", "soft_coverage")) + ("gather_fwd",))
    print(f"[fit {route}] profile over {PROFILE_ITERS} iterations "
          f"({card}): {prof}", flush=True)
    return {"counts": counts, "it_s_events": iters / events_s, "profile": prof,
            "it_s_wall": iters / wall_s, "loss": [float(loss[0]),
                                                   float(loss[-1])],
            "err": [err0, err1]}


# ---------------------------------------------------------------------------
# D. texture-sampling kernels at the joint fit's shapes
# ---------------------------------------------------------------------------

def tex_bound(args, C: int) -> tuple:
    """Bounds of the texture pair at these inputs: the map floats its taps
    cover (each distinct texel of a tap once, per map: one for a shared
    map), the corners, weights and outputs once each; the backward also the
    cotangent, the weight gradients and every d_maps float."""
    maps, y0, x0, wy, wx = args
    B, Hm, Wm, _ = maps.shape
    P = y0.shape[1]
    y = y0.long().clamp(0, Hm - 2)
    x = x0.long().clamp(0, Wm - 2)
    t = y * Wm + x
    taps = torch.stack([t, t + 1, t + Wm, t + Wm + 1])      # (4, B, P)
    if maps.stride(0) != 0:
        taps = taps + torch.arange(B, device=t.device)[:, None] * Hm * Wm
    texels = int(torch.unique(taps).numel())
    fwd = bound(texels * C * 4 + B * P * 16 + B * P * C * 4,
                B * P * ops_tex_fwd(C))
    bwd = bound(texels * C * 4 + B * P * 16 + B * P * C * 4
                + B * Hm * Wm * C * 4 + B * P * 8, B * P * ops_tex_bwd(C))
    return texels, fwd, bwd


def host_us(fn, n: int = 2000) -> float:
    """Host µs per call of fn() over n back-to-back calls (the card keeps
    up when the host is the slower)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def tex_check(tag: str, args, g, card: str, host: bool = False) -> dict:
    """texsample_fwd and texsample_bwd against their plain versions at the
    inputs args = (maps, y0, x0, wy, wx) and the cotangent g: the forward
    within 1e-6, d_maps, d_wy and d_wx each within 1e-5 of their largest
    (float32 atomics sum a texel in an order that changes from run to
    run). Times: by events, alone (the kernel by the profiler; for the
    backward also every kernel its wrapper launches, the zero fill
    included), the plain versions', and the library yardstick's:
    grid_sample (bilinear, border, align_corners) computes the same
    function at x = x0 + wx, y = y0 + wy, forward and backward, by events
    and alone (every kernel of the call). The host cost of a call is its
    events time less its device time. With host, the wrappers' host parts
    by the host clock: the operand check, the output allocation and the
    whole call (the launch is the rest), and grid_sample's call."""
    import torch.nn.functional as F

    from torch_renderer_tpu_torch.ops import cuda_texsample as ts

    maps, y0, x0, wy, wx = args
    B, Hm, Wm, C = maps.shape
    P = y0.shape[1]
    launches = (ts.FWD_LAUNCHES, ts.BWD_LAUNCHES)
    out_k = ts.texsample_fwd(*args)
    grads_k = ts.texsample_bwd(*args, g)
    launches = (ts.FWD_LAUNCHES - launches[0], ts.BWD_LAUNCHES - launches[1])
    out_p = ts.texsample_fwd_reference(*args)
    grads_p = ts.texsample_bwd_reference(*args, g)
    torch.cuda.synchronize()
    if launches != (1, 1):
        raise AssertionError(f"texsample ({tag}): {launches} launches for "
                             "one call of each wrapper")
    fwd_err = float((out_k - out_p).abs().max())
    print(f"[tex] {tag}: texsample_fwd vs plain at maps {tuple(maps.shape)} "
          f"(batch stride {maps.stride(0)}), P {P}: max|d| {fwd_err:.3e} "
          "(tol 1e-6)", flush=True)
    if not fwd_err <= 1e-6:
        raise AssertionError(f"texsample_fwd ({tag}) disagrees with its "
                             "plain version")
    bwd_err = 0.0
    for name, a, b in zip(("d_maps", "d_wy", "d_wx"), grads_k, grads_p):
        err = float((a - b).abs().max())
        tol = 1e-5 * float(b.abs().max())
        print(f"[tex] {tag}: texsample_bwd {name} vs plain: max|d| "
              f"{err:.3e} (tol {tol:.3e} = 1e-5 x max "
              f"{float(b.abs().max()):.3e})", flush=True)
        if not err <= tol:
            raise AssertionError(f"texsample_bwd {name} ({tag}) disagrees "
                                 "with its plain version")
        bwd_err = max(bwd_err, err)
    live = int((g != 0).any(-1).sum())

    inp = maps.permute(0, 3, 1, 2).contiguous()            # (B, C, Hm, Wm)
    grid = torch.stack([2.0 * (x0 + wx) / (Wm - 1) - 1.0,
                        2.0 * (y0 + wy) / (Hm - 1) - 1.0],
                       dim=-1)[:, None]                    # (B, 1, P, 2)
    kw = dict(mode="bilinear", padding_mode="border", align_corners=True)
    lib = F.grid_sample(inp, grid, **kw)[:, :, 0].transpose(1, 2)
    lib_err = float((lib - out_p).abs().max())
    print(f"[tex] {tag}: grid_sample vs plain: max|d| {lib_err:.3e} (tol "
          "1e-4: its weights round from the normalized grid)", flush=True)
    if not lib_err <= 1e-4:
        raise AssertionError("grid_sample does not compute the same function")
    inp_r = inp.clone().requires_grad_(True)
    grid_r = grid.clone().requires_grad_(True)
    lib_out = F.grid_sample(inp_r, grid_r, **kw)
    g_lib = g.transpose(1, 2)[:, :, None].contiguous()    # (B, C, 1, P)

    def lib_fwd():
        return F.grid_sample(inp, grid, **kw)

    def lib_bwd():
        return torch.autograd.grad(lib_out, (inp_r, grid_r), g_lib,
                                   retain_graph=True)

    bwd_all = wrapper_device(lambda: ts.texsample_bwd(*args, g))
    times = {
        "fwd": time_ms(lambda: ts.texsample_fwd(*args)),
        "fwd_plain": time_ms(lambda: ts.texsample_fwd_reference(*args)),
        "fwd_library": time_ms(lib_fwd),
        "bwd": time_ms(lambda: ts.texsample_bwd(*args, g)),
        "bwd_plain": time_ms(lambda: ts.texsample_bwd_reference(*args, g)),
        "bwd_library": time_ms(lib_bwd),
        "fwd_device": device_ms(lambda: ts.texsample_fwd(*args),
                                "texsample_fwd_kernel"),
        "bwd_device": device_ms(lambda: ts.texsample_bwd(*args, g),
                                "texsample_bwd_kernel"),
        "bwd_all_device": bwd_all["all_device_ms"],
        "bwd_kernels_per_call": bwd_all["kernels_per_call"],
        "bwd_kernel_names": bwd_all["kernel_names"],
        "fwd_library_device": device_ms(lib_fwd, None),
        "bwd_library_device": device_ms(lib_bwd, None),
    }
    times["fwd_host"] = times["fwd"] - times["fwd_device"]
    times["bwd_host"] = times["bwd"] - times["bwd_all_device"]
    times["fwd_library_host"] = times["fwd_library"] \
        - times["fwd_library_device"]
    times["bwd_library_host"] = times["bwd_library"] \
        - times["bwd_library_device"]
    texels, b_fwd, b_bwd = tex_bound(args, C)
    rec = {"shape": [B, Hm, Wm, C, P], "map_batch_stride": maps.stride(0),
           "live_points": live, "texels": texels, "fwd_err": fwd_err,
           "bwd_err": bwd_err, "times": times, "bound_fwd": b_fwd,
           "bound_bwd": b_bwd}
    if host:
        parts = {
            "check_fwd_us": host_us(lambda: ts._check_inputs(*args)),
            "alloc_fwd_us": host_us(lambda: maps.new_empty((B, P, C))),
            "call_fwd_us": host_us(lambda: ts.texsample_fwd(*args)),
            "check_bwd_us": host_us(lambda: ts._check_inputs(*args, g)),
            "alloc_bwd_us": host_us(lambda: (
                maps.new_zeros((B, Hm, Wm, C)), wy.new_empty((B, P)),
                wx.new_empty((B, P)))),
            "call_bwd_us": host_us(lambda: ts.texsample_bwd(*args, g)),
            "grid_sample_us": host_us(lib_fwd),
        }
        for k in ("fwd", "bwd"):
            parts[f"launch_{k}_us"] = parts[f"call_{k}_us"] \
                - parts[f"check_{k}_us"] - parts[f"alloc_{k}_us"]
        rec["host_parts"] = parts
    print(f"[tex] {tag} ({card}): {rec}", flush=True)
    return rec


def texture_phase(device, card: str) -> dict:
    """Phase D at its uniform shape: one map shared by 2 views, 32768
    points a view at u, v uniform in [0, 1], a random cotangent."""
    from torch_renderer_tpu_torch.structures.textures import (
        bilinear_corners,
    )

    B, T, C, P = 2, TEX_SIZE, 3, TEX_POINTS
    gen = torch.Generator(device=device).manual_seed(3)
    tmap = torch.rand((T, T, C), generator=gen, device=device)
    maps = tmap[None].expand(B, T, T, C)       # one map, batch stride 0
    uv = torch.rand((B, P, 2), generator=gen, device=device)
    y0, x0, wy, wx = (a.contiguous() for a in bilinear_corners(uv, T, T))
    g = torch.randn((B, P, C), generator=gen, device=device)
    return tex_check("uniform uv", (maps, y0, x0, wy, wx), g, card,
                     host=True)


@contextlib.contextmanager
def spy_texture_samples(seen: dict):
    """Record, in seen, the texture sampler's operands (maps, y0, x0, wy,
    wx) of each TexturesUV.sample call and, once autograd brings it, the
    cotangent of its samples ("g")."""
    from torch_renderer_tpu_torch.structures import textures

    saved = textures.sample_bilinear

    def spy(maps, y0, x0, wy, wx):
        out = saved(maps, y0, x0, wy, wx)
        seen["args"] = tuple(a.detach() for a in (maps, y0, x0, wy, wx))
        out.register_hook(lambda g: seen.update(g=g.detach().contiguous()))
        return out

    textures.sample_bilinear = spy
    try:
        yield seen
    finally:
        textures.sample_bilinear = saved


def fit_samples(fitter, params, src, uvs, ds) -> tuple:
    """The texture sampler's operands and its cotangent in one loss of the
    fitted mesh and texture on views 0 and 1, as the fit computes it: the
    app's 128x128 images, shade_k 2 slots a pixel, empty fragments
    included; the cotangent from autograd."""
    from torch_renderer_tpu_torch.ops.mesh_losses import build_topology

    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    views = torch.arange(2, device=src.device)
    with spy_texture_samples({}) as seen:
        total, _ = fitter.loss(p, src, build_topology(src), uvs, ds, views)
        total.backward()
    return seen["args"], seen["g"]


# ---------------------------------------------------------------------------
# E. the joint shape + UV-texture fit at the app's defaults
# ---------------------------------------------------------------------------

def _busy_share(fn, iters: int, top: int = 0, named: tuple = (),
                under: tuple = ()) -> dict:
    """Device busy time (union of device events) and kernels per iteration
    over fn(), which runs `iters` iterations, by torch.profiler; with top,
    also the `top` kernel names with the most device time per iteration;
    for each string in named, the device ms per iteration of the kernels
    whose names hold it and their share of the busy time; for each string
    in under, the device ms and the count per iteration of the kernels not
    in named that were launched inside a CPU op whose name holds it (an
    autograd node's, "TexSampleBackward": the ops its backward runs)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # drop only the optimizer's annotation span; kernel names may hold '#'
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not e.name.startswith(("Optimizer.", "ProfilerStep"))]
    cpu_ops = [e for e in prof.events()
               if e.device_type == DeviceType.CPU and e.kernels]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    out = {"kernels_per_iter": len(spans) / iters,
           "busy_ms_per_iter": busy_us / 1e3 / iters,
           "wall_ms_per_iter": wall_ms / iters,
           "busy_share": busy_us / 1e3 / wall_ms}
    if top:
        per_name: dict = {}
        for e in events:
            per_name[e.name[:70]] = per_name.get(e.name[:70], 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / iters
        out["top_ms_per_iter"] = dict(sorted(
            per_name.items(), key=lambda kv: -kv[1])[:top])
    for n in named:
        ms = sum(e.time_range.end - e.time_range.start for e in events
                 if n in e.name) / 1e3 / iters
        out[f"{n}_ms_per_iter"] = ms
        out[f"{n}_share_of_busy"] = ms / max(out["busy_ms_per_iter"], 1e-12)

    def inside(op, n):
        while op is not None:
            if n in op.name:
                return True
            op = op.cpu_parent
        return False

    # the profiler lists each device kernel under the CPU op that
    # launched it (FunctionEvent.kernels, durations in µs)
    for n in under:
        hit = [k for op in cpu_ops if inside(op, n) for k in op.kernels
               if not any(m in k.name for m in named)]
        out[f"under_{n}_ms_per_iter"] = sum(
            k.duration for k in hit) / 1e3 / iters
        out[f"under_{n}_kernels_per_iter"] = len(hit) / iters
        out[f"under_{n}_names"] = sorted({_short(k.name) for k in hit})
    return out


def joint_fit_phase(device, card: str, iters: int = JOINT_ITERS) -> dict:
    from torch_renderer_tpu_torch.apps._common import pinhole_K
    from torch_renderer_tpu_torch.apps.joint_shape_texture import (
        striped_target,
    )
    from torch_renderer_tpu_torch.ops.icosphere import icosphere
    from torch_renderer_tpu_torch.ops.knn_chamfer import chamfer_distance
    from torch_renderer_tpu_torch.ops.sample_points import (
        sample_points_from_meshes,
    )
    from torch_renderer_tpu_torch.opt.deform_color import (
        JointFitConfig,
        JointShapeTextureFitter,
    )
    from torch_renderer_tpu_torch.rasterize import cuda_hard
    from torch_renderer_tpu_torch.rasterize.binning import (
        count_active_tiles,
        count_overflow,
        set_budget_check_default,
    )
    from torch_renderer_tpu_torch.rasterize.geometry import (
        setup_face_planes,
        setup_faces,
    )
    from torch_renderer_tpu_torch.structures.meshes import Meshes
    from torch_renderer_tpu_torch.structures.textures import (
        sphere_uv_mapping,
    )

    set_budget_check_default("off")
    size = (JOINT_IMAGE, JOINT_IMAGE)
    verts, faces = icosphere(JOINT_LEVEL)
    src = Meshes.from_single(verts, faces, device=device)
    uvs = torch.as_tensor(sphere_uv_mapping(verts), device=device)
    tgt = striped_target(verts, faces, uvs, device)
    fitter = JointShapeTextureFitter(pinhole_K(size), size,
                                     JointFitConfig(n_steps=iters),
                                     device=device)
    t0 = time.perf_counter()
    ds = fitter.make_dataset(tgt)
    torch.cuda.synchronize()
    print(f"[joint] dataset: {ds['rgb'].shape[0]} views in "
          f"{time.perf_counter() - t0:.2f} s, settings "
          f"{fitter.renderer.settings}", flush=True)

    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t_start = time.perf_counter()
    start.record()
    params, hist = fitter.fit(src, uvs, ds, torch.Generator().manual_seed(0))
    stop.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t_start
    counts = read_counts()
    events_s = start.elapsed_time(stop) / 1000.0

    h = {k: v.cpu().numpy() for k, v in hist.items()}
    sil, rgb = h["sil_mse"], h["rgb_mse"]
    sil0, sil1 = float(sil[:20].mean()), float(sil[-20:].mean())
    rgb0, rgb1 = float(rgb[:20].mean()), float(rgb[-20:].mean())
    max_deform = float(params["deform"].abs().max())

    def cham(mesh):
        gen = torch.Generator(device=device).manual_seed(7)
        a = sample_points_from_meshes(mesh, 2000, gen)
        b = sample_points_from_meshes(tgt, 2000, gen)
        return float(chamfer_distance(a, b)[0])

    final = src.offset_verts(params["deform"])
    c0, c1 = cham(src), cham(final)
    print(f"[joint] sil MSE {sil0:.5f} -> {sil1:.5f}; rgb MSE {rgb0:.5f} -> "
          f"{rgb1:.5f} (means of the first / last 20 steps); max|deform| "
          f"{max_deform:.4f}; chamfer {c0:.6f} -> {c1:.6f}; launches "
          f"{counts}", flush=True)
    print(f"[joint] {iters} iters: {iters / events_s:.1f} it/s by CUDA "
          f"events ({events_s * 1000.0 / iters:.4f} ms/iter), "
          f"{iters / wall_s:.1f} it/s by host wall time "
          f"({wall_s * 1000.0 / iters:.4f} ms/iter) on {card}", flush=True)

    # the budgets sized at set-up against the fitted mesh's footprint
    st = fitter.renderer.settings
    with torch.no_grad():
        fd = setup_faces(final.extend(ds["R"].shape[0]),
                         fitter.renderer.camera_with_pose(ds["R"], ds["t"]))
        pad = math.sqrt(st.blur_radius)
        mx = int(count_overflow(fd, size, st.bin_size, 0, pad)[0])
        act = int(count_active_tiles(fd, size, st.bin_size, pad))
    print(f"[joint] fitted footprint: max faces per bin {mx} (budget "
          f"{st.max_faces_per_bin}), active tiles {act} (budget "
          f"{st.active_tiles})", flush=True)

    if not all(np.isfinite(v).all() for v in h.values()) \
            or sil.shape != (iters,):
        raise AssertionError("joint fit: a loss is not finite")
    if not (sil1 < 0.7 * sil0 and rgb1 < 0.7 * rgb0):
        raise AssertionError("joint fit: the silhouette or RGB MSE did not "
                             "fall below 0.7x its start")
    if not max_deform < 0.5:
        raise AssertionError(f"joint fit: vertex offsets exploded "
                             f"({max_deform})")
    if not c1 < 0.5 * c0:
        raise AssertionError(f"joint fit: chamfer {c0} -> {c1} did not fall "
                             "below 0.5x its start")
    want = only(counts, texsample_fwd=iters, texsample_bwd=iters,
                topk_select=iters, gather_tiles_fwd=iters,
                untile_scatter=iters)
    if counts != want:
        raise AssertionError(f"joint fit: expected launches {want}, got "
                             f"{counts}")

    # topk_select at the fit's shapes: 2 views of the fitted mesh, K=8
    with torch.no_grad():
        cam = fitter.renderer.camera_with_pose(ds["R"][:2], ds["t"][:2])
        inp = cuda_hard.binned_inputs(setup_face_planes(final.extend(2), cam),
                                      st)
    targs = (inp.slab, inp.count, inp.origin, st.faces_per_pixel,
             st.bin_size, inp.inv_s, st.blur_radius, st.znear)
    l_k = cuda_hard.topk_select(*targs)
    l_p = cuda_hard.topk_select_reference(*targs)
    torch.cuda.synchronize()
    prio = cuda_hard._priority(inp.slab, inp.count, inp.origin, *targs[4:8])
    gap, n_diff = _winner_check("topk_select K=8 (joint fit)", l_k, l_p,
                                prio)
    topk = {"max_abs_err": gap, "diff_px": n_diff,
            "shape": list(inp.slab.shape),
            "ms": time_ms(lambda: cuda_hard.topk_select(*targs)),
            "device_ms": device_ms(lambda: cuda_hard.topk_select(*targs),
                                   "topk_select"),
            "plain_ms": time_ms(
                lambda: cuda_hard.topk_select_reference(*targs)),
            **hard_bound(inp.slab, inp.count, inp.origin,
                         st.faces_per_pixel, OPS_TOPK, st.bin_size,
                         inp.inv_s, st.blur_radius)}
    print(f"[joint] topk_select K=8 at {topk['shape']} ({card}): kernel "
          f"{topk['ms']:.4f} ms (device {topk['device_ms']} ms), plain "
          f"{topk['plain_ms']:.4f} ms, bound "
          f"{topk['bound_ms']:.6f} ms ({topk['bound_by']}; "
          f"{topk['box_pairs']} of {topk['pairs']} live pairs in a face's "
          f"box), every-pair bound {topk['bound_every_pair_ms']:.6f} ms",
          flush=True)

    # the texture pair where the fit samples: 2 views of the fitted mesh
    frag_args, frag_g = fit_samples(fitter, params, src, uvs, ds)
    tex = tex_check("joint fit fragments", frag_args, frag_g, card)

    # device time of the texture pair, and of what its backward brings:
    # the zero fill of d_maps (inside TexSampleBackward) and the sum over
    # the views of the shared map (the expand's backward)
    prof = _busy_share(lambda: fitter.fit(
        src, uvs, ds, torch.Generator().manual_seed(1),
        n_steps=PROFILE_ITERS, params0=params), PROFILE_ITERS,
        named=("topk_select", "texsample"),
        under=("TexSampleBackward", "ExpandBackward"))
    print(f"[joint] profile over {PROFILE_ITERS} iterations ({card}): "
          f"{prof}", flush=True)
    return {"counts": counts, "it_s_events": iters / events_s,
            "it_s_wall": iters / wall_s, "sil": [sil0, sil1],
            "rgb": [rgb0, rgb1], "chamfer": [c0, c1],
            "max_deform": max_deform, "topk": topk, "tex": tex,
            "profile": prof}


# ---------------------------------------------------------------------------
# F. the point stack at the point bench scene
# ---------------------------------------------------------------------------

def points_scene(device):
    """scripts/bench_points.py's scene: the cloud, K, R, t and the budgets
    it sizes (alpha and sphere)."""
    from torch_renderer_tpu_torch.rasterize.points import (
        PointsRasterizationSettings,
        suggest_active_tiles_points,
        suggest_points_per_bin,
    )
    from torch_renderer_tpu_torch.renderer import (
        AlphaPointRender,
        PulsarRenderer,
    )
    from torch_renderer_tpu_torch.structures.pointclouds import Pointclouds

    B, N, S = POINTS_B, POINTS_N, POINTS_IMAGE
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((B, N, 3)).astype(np.float32) * 0.8
    feats = rng.uniform(0.0, 1.0, (B, N, 3)).astype(np.float32)
    cloud = Pointclouds.from_padded(pts, features=feats, device=device)
    f = 0.8 * S
    K = np.array([[f, 0, S / 2.0], [0, f, S / 2.0], [0, 0, 1.0]], np.float32)
    R = torch.eye(3, device=device).expand(B, 3, 3)
    t = torch.tensor([[0.0, 0.0, 2.5]], device=device).expand(B, 3)
    probe = PointsRasterizationSettings((S, S), radius=POINTS_RADIUS,
                                        bin_size=16)
    cam = AlphaPointRender(K, (S, S), device=device).camera_with_pose(R, t)
    sph = PulsarRenderer(K, (S, S), radius=POINTS_RADIUS, bin_size=16,
                         device=device)
    cam_s = sph.camera_with_pose(R, t)
    with torch.no_grad():
        _, _, r_ndc = sph._selection_radii(cloud, cam_s)
    budgets = {
        "mpb": suggest_points_per_bin(cloud, cam, probe),
        "mpb_sphere": suggest_points_per_bin(cloud, cam_s, probe,
                                             radius=r_ndc),
        "act": suggest_active_tiles_points(cloud, cam, probe),
        "act_sphere": suggest_active_tiles_points(cloud, cam_s, probe,
                                                  radius=r_ndc),
    }
    return cloud, K, R, t, budgets


def _rim_share(frags_b, frags_d, cloud, cam, radius: float) -> dict:
    """Pixels whose point ids differ between the binned and dense
    fragments, and whether each lies on a splat's rim: some valid point's
    d^2 (direct form) within POINTS_MISS of r^2."""
    from torch_renderer_tpu_torch.rasterize.points import (
        project_points_screen,
    )
    from torch_renderer_tpu_torch.rasterize.soft import pixel_coords_raster

    diff = (frags_b.idx != frags_d.idx).any(-1)               # (B, H, W)
    covered = int((frags_d.idx[..., 0] >= 0).sum())
    b_i, y_i, x_i = torch.nonzero(diff, as_tuple=True)
    H, W = cam.image_size
    q, _, valid = project_points_screen(cloud, cam, 1e-5)
    pix = pixel_coords_raster((H, W), q.device)[y_i * W + x_i]  # (n, 2)
    r2 = torch.tensor(radius * radius, dtype=torch.float32, device=q.device)
    on_rim = torch.zeros_like(b_i, dtype=torch.bool)
    for b in range(q.shape[0]):
        sel = b_i == b
        if bool(sel.any()):
            d = pix[sel][:, None, :] - q[b][None]
            d2 = (d * d).sum(-1)
            rim = ((d2 - r2).abs() <= POINTS_MISS) & valid[b][None]
            on_rim[sel] = rim.any(-1)
    n = int(diff.sum())
    return {"differ": n, "covered": covered,
            "off_rim": n - int(on_rim.sum()),
            "share": n / max(covered, 1)}


def point_box_pairs(slab, count, origin, offs, r2, znear: float) -> int:
    """Live (pixel, candidate) pairs whose pixel lies in the splat's box
    x +- r, y +- r (r = sqrt(r^2); none for a point at or behind znear):
    a splat covers no pixel outside it, so only these pairs need the
    coverage test; the others need only a box test. Pixel coordinates are
    origin + offs, a row-major tile grid."""
    tile = math.isqrt(offs.shape[0])
    P = max(1, int(count.max()))
    x, y, z = (slab[:, :, :P, c] for c in range(3))
    rr = slab[:, :, :P, 3] if r2 is None else torch.full_like(x, r2)
    r = torch.sqrt(rr.clamp_min(0.0))[..., None]
    xs = (offs[:tile, 0] + origin[..., 0:1])[:, :, None, :]   # (B, A, 1, T)
    ys = (offs[::tile, 1] + origin[..., 1:2])[:, :, None, :]
    nx = ((xs >= x[..., None] - r) & (xs <= x[..., None] + r)).sum(-1)
    ny = ((ys >= y[..., None] - r) & (ys <= y[..., None] + r)).sum(-1)
    live = ((torch.arange(P, device=slab.device) < count[..., None])
            & (z > znear) & (rr >= 0.0))
    return int((nx * ny * live).sum())


def points_plan(tile: int, K: int, tiles: int, device):
    """(P, R, S) of a points_select launch over `tiles` tiles: blocks a
    tile, rows a block, thread groups a pixel (the launcher's plan); None
    for a library without the planner (trees before the split kernel)."""
    import ctypes

    from torch_renderer_tpu_torch import _build

    lib = _build.load_kernels()
    if not hasattr(lib, "trt_points_plan"):
        return None
    plan = (ctypes.c_int * 3)()
    rc = lib.trt_points_plan(tile, K, tiles, ctypes.addressof(plan),
                             device.index)
    if rc:
        raise RuntimeError(f"trt_points_plan failed: CUDA error {rc}")
    return list(plan)


def points_phase(device, card: str) -> dict:
    from torch_renderer_tpu_torch.rasterize import autotune, cuda_points
    from torch_renderer_tpu_torch.rasterize.binning import (
        set_budget_check_default,
    )
    from torch_renderer_tpu_torch.rasterize.points import (
        PointsRasterizationSettings,
        project_points_screen,
        rasterize_points,
    )
    from torch_renderer_tpu_torch.renderer import (
        AlphaPointRender,
        DepthPointRender,
        NormPointRender,
        PulsarPointRender,
        PulsarRenderer,
    )

    set_budget_check_default("off")
    autotune.clear_cache()
    torch.cuda.reset_peak_memory_stats()
    cloud, K, R, t, bud = points_scene(device)
    S, rad = POINTS_IMAGE, POINTS_RADIUS
    print(f"[points] scene: B={POINTS_B} x {POINTS_N} points, {S}^2, "
          f"radius {rad}, K=8; budgets {bud}", flush=True)
    bkw = dict(radius=rad, bin_size=16, max_points_per_bin=bud["mpb"])
    auto = AlphaPointRender(K, (S, S), radius=rad, device=device)
    st_auto = auto.prepare(cloud, R, t)
    print(f"[points] alpha auto-resolved: {st_auto}", flush=True)
    renderers = {
        "alpha_auto": auto,
        "alpha_explicit_act": AlphaPointRender(
            K, (S, S), active_tiles=bud["act"], device=device, **bkw),
        "norm": NormPointRender(K, (S, S), device=device, **bkw),
        "pulsar_splat": PulsarPointRender(K, (S, S), device=device, **bkw),
        "pulsar_sphere_act": PulsarRenderer(
            K, (S, S), radius=rad, bin_size=16,
            max_points_per_bin=bud["mpb_sphere"],
            active_tiles=bud["act_sphere"], device=device),
        "depth": DepthPointRender(K, (S, S), device=device, **bkw),
    }

    # the kernel against its plain version on the scene's two slabs
    sph = renderers["pulsar_sphere_act"]
    cam = auto.camera_with_pose(R, t)
    cam_s = sph.camera_with_pose(R, t)
    slabs = {}
    with torch.no_grad():
        q, z, valid = project_points_screen(cloud, cam, st_auto.znear)
        slabs["uniform"] = (cuda_points.binned_point_inputs(
            q, z, valid, torch.full_like(z, rad * rad), st_auto,
            uniform_r2=rad * rad), st_auto)
        _, _, r_ndc = sph._selection_radii(cloud, cam_s)
        q, z, valid = project_points_screen(cloud, cam_s, sph.settings.znear)
        slabs["per_point"] = (cuda_points.binned_point_inputs(
            q, z, valid, r_ndc * r_ndc, sph.settings), sph.settings)
    kern = {}
    for name, (inp, st) in slabs.items():
        args = (inp.slab, inp.count, inp.origin, inp.offs,
                st.points_per_pixel, st.znear, inp.r2)
        lane_k = cuda_points.points_select(*args)
        lane_p = cuda_points.points_select_reference(*args)
        torch.cuda.synchronize()
        same = bool(torch.equal(lane_k, lane_p))
        live = int(inp.count.sum())
        B_, A_, P_, C_ = inp.slab.shape
        tp = inp.offs.shape[0]
        Kp = st.points_per_pixel
        n_bytes = (live * (16 if inp.r2 is None else 12) + B_ * A_ * 12
                   + tp * 8 + B_ * A_ * Kp * tp * 4)
        n_box = point_box_pairs(inp.slab, inp.count, inp.origin, inp.offs,
                                inp.r2, st.znear)
        b = bound(n_bytes, n_box * OPS_POINTS
                  + (live * tp - n_box) * OPS_BOX)
        every = bound(n_bytes, live * tp * OPS_POINTS)
        kern[name] = {
            "max_abs_err": 0.0 if same else float("inf"),
            "shape": list(inp.slab.shape), "live": live,
            "max_per_tile": int(inp.count.max()),
            "mean_per_tile": live / (B_ * A_),
            "plan": points_plan(math.isqrt(tp), Kp, B_ * A_, inp.slab.device),
            "box_pairs": n_box, "pairs": live * tp,
            "bound_every_pair_ms": every["bound_ms"],
            "bound_every_pair_by": every["bound_by"],
            "covered_px": int((lane_k[:, :, 0] >= 0).sum()),
            "ms": time_ms(lambda: cuda_points.points_select(*args)),
            "device_ms": device_ms(lambda: cuda_points.points_select(*args),
                                   "points_select_kernel"),
            "plain_ms": time_ms(
                lambda: cuda_points.points_select_reference(*args)),
            **b}
        print(f"[points] points_select {name} r^2 at slab "
              f"{kern[name]['shape']} ({live} live candidates, max {kern[name]['max_per_tile']} "
              f"per tile): winners identical to plain: {same}; kernel "
              f"{kern[name]['ms']:.4f} ms (device {kern[name]['device_ms']} "
              f"ms), plain {kern[name]['plain_ms']:.4f} ms, bound "
              f"{b['bound_ms']:.6f} ms ({b['bound_by']}: {b['bytes']} B, "
              f"{b['ops']} op; {n_box} of {live * tp} live pairs in a "
              f"splat's box), every-pair bound {every['bound_ms']:.6f} ms; "
              f"plan (P, R, S) {kern[name]['plan']} on {card}", flush=True)
        if not same:
            raise AssertionError(f"points_select ({name} r^2) disagrees with "
                                 "its plain version")

    # binned alpha fragments against the dense path on the card
    with torch.no_grad():
        fb = rasterize_points(cloud, cam, st_auto)
        fd = rasterize_points(cloud, cam, PointsRasterizationSettings(
            (S, S), radius=rad, bin_size=0))
    rim = _rim_share(fb, fd, cloud, cam, rad)
    same = fb.idx == fd.idx
    z_err = float((fb.zbuf - fd.zbuf).abs()[same].max())
    d_err = float((fb.dists2 - fd.dists2).abs()[same].max())
    print(f"[points] binned vs dense alpha fragments: {rim['differ']} of "
          f"{rim['covered']} covered pixels differ in an id "
          f"({rim['share']:.2e}), {rim['off_rim']} of them off a splat rim; "
          f"max|dzbuf| {z_err:.3e}, max|ddists2| {d_err:.3e} where the ids "
          "agree (tol 1e-6)", flush=True)
    if rim["off_rim"] or rim["share"] > TIE_SHARE:
        raise AssertionError("binned point ids disagree with the dense path "
                             "beyond rim pixels")
    if not (z_err <= 1e-6 and d_err <= 1e-6):
        raise AssertionError("binned point values disagree with the dense "
                             "path")
    del fd

    # 20 renders and 20 grad steps of each renderer
    def grad_step(r):
        x = cloud.points.detach().requires_grad_(True)
        img = r.render(dataclasses.replace(cloud, points=x), R, t)
        (g,) = torch.autograd.grad((img * img).sum(), x)
        return img, g

    runs = {}
    reset_counts()
    torch.cuda.synchronize()
    for name, r in renderers.items():
        img, g = grad_step(r)                 # warm-up, resolution
        torch.cuda.synchronize()
        finite = torch.ones((), dtype=torch.bool, device=device)
        before = read_counts()["points_select"]
        start = torch.cuda.Event(enable_timing=True)
        mid = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(POINTS_STEPS):
            img = r.render(cloud, R, t)
            finite &= torch.isfinite(img).all()
        mid.record()
        torch.cuda.synchronize()
        n_fwd = read_counts()["points_select"] - before
        for _ in range(POINTS_STEPS):
            img, g = grad_step(r)
            finite &= torch.isfinite(img).all() & torch.isfinite(g).all()
        stop.record()
        torch.cuda.synchronize()
        n_all = read_counts()["points_select"] - before
        runs[name] = {
            "fwd_ms": start.elapsed_time(mid) / POINTS_STEPS,
            "grad_ms": mid.elapsed_time(stop) / POINTS_STEPS,
            "launches_fwd": n_fwd, "launches_grad": n_all - n_fwd,
            "shape": list(img.shape)}
        print(f"[points] {name}: forward {runs[name]['fwd_ms']:.4f} ms, "
              f"grad step {runs[name]['grad_ms']:.4f} ms (CUDA events over "
              f"{POINTS_STEPS}), out {runs[name]['shape']}, launches "
              f"{n_fwd} + {n_all - n_fwd} on {card}", flush=True)
        if not bool(finite):
            raise AssertionError(f"{name}: a non-finite output or gradient")
        if n_fwd != POINTS_STEPS or n_all != 2 * POINTS_STEPS:
            raise AssertionError(f"{name}: expected one points_select launch "
                                 f"per render and grad step, got {n_fwd} "
                                 f"and {n_all - n_fwd}")
    counts = read_counts()
    n_render = len(renderers) * (2 * POINTS_STEPS + 1)
    want = only(counts, points_select=n_render, gather_tiles_fwd=n_render)
    if counts != want:
        raise AssertionError(f"points: expected launches {want}, got "
                             f"{counts}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"[points] main path launches {counts}; peak device memory "
          f"{peak_gb:.3f} GiB", flush=True)

    prof = _busy_share(lambda: [grad_step(auto)
                                for _ in range(PROFILE_ITERS)],
                       PROFILE_ITERS, top=8)
    print(f"[points] alpha grad-step profile over {PROFILE_ITERS} steps "
          f"({card}): {prof}", flush=True)
    set_budget_check_default(None)
    return {"counts": counts, "kernel": kern, "runs": runs, "rim": rim,
            "budgets": bud, "peak_gb": peak_gb, "profile": prof}


# ---------------------------------------------------------------------------
# G. the batched multi-view depth render (apps/batch_render_bench)
# ---------------------------------------------------------------------------

BATCH_SIZE = (720, 1280)
BATCH_VIEWS = 120
BATCH_CHUNK = 12
BATCH_TILE = 32


def _batch_chunk(device, app: dict):
    """One call's inputs at the app's defaults: the first 12 of its 120
    views of the normalized level-3 icosphere, and the app's settings with
    the budgets it sized."""
    import torch_renderer_tpu_torch as trt
    from torch_renderer_tpu_torch.apps._common import pinhole_K

    meshes = trt.Meshes.from_single(*trt.icosphere(LEVEL), device=device)
    meshes, _, _ = meshes.center_and_scale_to_unit_sphere()
    azims = np.linspace(0.0, 360.0, BATCH_VIEWS, endpoint=False)
    R, t = trt.look_at_view_transform(
        2.7, 15.0, torch.from_numpy(azims[:BATCH_CHUNK].astype(np.float32)))
    act = app["active_tiles"]
    kw = dict(pixel_chunk=1048576, bin_size=BATCH_TILE,
              max_faces_per_bin=app["max_faces_per_bin"],
              active_tiles=None if act < 0 else act,
              select_impl="affine", device=device)
    return (meshes.extend(BATCH_CHUNK), R.to(device), t.to(device),
            pinhole_K(BATCH_SIZE), kw)


def _untile_backward_check(device) -> dict:
    """K=4 blur fragments and the soft silhouette's vertex gradient through
    the untile kernel's wrapper (its backward in plain torch) against the
    plain epilogue differentiated by autograd, at 96^2, bin 16: fragments
    equal, gradients within 1e-5 of the largest. The untile backward is
    exact; the gradient's scatter-adds downstream (the winners' corner
    gather) sum in float32 atomics whose order changes from run to run, so
    the plain epilogue runs twice to show that spread."""
    import torch_renderer_tpu_torch as trt

    S = 96
    f = 0.8 * S
    K = np.array([[f, 0, S / 2], [0, f, S / 2], [0, 0, 1]], np.float32)
    m = trt.Meshes.from_single(*trt.icosphere(2), device=device)
    R, t = trt.look_at_view_transform(3.0, 25.0, 40.0)
    R, t = R.to(device), t.to(device)
    r = trt.MeshRenderer(K, (S, S), blur_radius=POSE_BLUR, faces_per_pixel=4,
                         bin_size=16, max_faces_per_bin=128, device=device)

    def run():
        v = m.verts.clone().requires_grad_(True)
        o = r.render(m.update_padded(v), R, t)
        (g,) = torch.autograd.grad((o.silhouette ** 2).sum(), v)
        return o.fragments, g

    with plain_epilogue():
        fa, ga = run()
    fb, gb = run()
    with plain_epilogue():
        _, ga2 = run()
    same = all(torch.equal(getattr(fa, n), getattr(fb, n))
               for n in ("pix_to_face", "zbuf", "bary", "dists"))
    err = float((ga - gb).abs().max())
    spread = float((ga - ga2).abs().max())
    tol = 1e-5 * float(ga.abs().max())
    print(f"[batch] untile backward at {S}^2, K=4, blur {POSE_BLUR:.3e}, "
          f"bin 16: fragments equal: {same}; silhouette vertex gradient "
          f"kernel vs plain max|d| {err:.3e}, plain vs plain {spread:.3e} (tol "
          f"{tol:.3e} = 1e-5 x max|g| {float(ga.abs().max()):.3e})",
          flush=True)
    if not same or not err <= tol or not bool(torch.isfinite(gb).all()):
        raise AssertionError("the untile epilogue disagrees with its plain "
                             "version in the K=4 fragments or their gradient")
    return {"err": err, "spread": spread, "tol": tol}


def take_inputs(rows, bg, table, image_size, tile: int, n_tiles_hw):
    """The untile yardstick's inputs for one field: its rows with a
    background row appended at slot A, (B, A + 1, tile^2, C) contiguous,
    and the (B, H, W, C) index map into them, so that one torch.take
    computes the kernel's function."""
    B, A, P, C = rows.shape
    H, W = image_size
    src = torch.cat([rows, rows.new_full((B, 1, P, C), bg)], dim=1)
    y = torch.arange(H, device=rows.device)[:, None]
    x = torch.arange(W, device=rows.device)[None, :]
    t = (y // tile) * n_tiles_hw[1] + x // tile                 # (H, W)
    p = (y % tile) * tile + x % tile
    slot = table.long().clamp(0, A)[:, t]                       # (B, H, W)
    b = torch.arange(B, device=rows.device)[:, None, None]
    idx = (((b * (A + 1) + slot) * P + p) * C)[..., None] \
        + torch.arange(C, device=rows.device)
    return src.contiguous(), idx


def untile_check(tag: str, bins, fields: dict, image_size, tile: int,
                 card: str):
    """The untile kernel on all Fragments fields of one binned raster (one
    launch) against its plain version on each field (equal), timed by events, by
    the profiler and the plain version; the library yardstick is one
    torch.take per field through an index map built before the timing
    (take_inputs), checked equal too. Its bound: the active rows it
    copies, the slot table once and the images written once. Returns
    (record, tiles that copy)."""
    from torch_renderer_tpu_torch.rasterize import cuda_untile

    fwd = cuda_untile.untile_scatter_fields_fwd
    A = bins.invrank.shape[1]
    nthw = bins.n_tiles_hw
    table = cuda_untile.tile_slot_table(bins.rank, A, nthw)
    n_read = int((table < A).sum())          # tiles that copy an active row
    flat = [(v.reshape(v.shape[:3] + (-1,)), bg) for v, bg in fields.values()]
    args = (flat, table, image_size, tile, nthw)

    def plain():
        return [cuda_untile.untile_scatter_reference(
            rows, table, bg, image_size, tile, nthw) for rows, bg in flat]

    takes = [take_inputs(rows, bg, table, image_size, tile, nthw)
             for rows, bg in flat]

    def library():
        return [torch.take(src, idx) for src, idx in takes]

    imgs, want, lib = fwd(*args), plain(), library()
    torch.cuda.synchronize()
    n_bytes = table.numel() * 4
    per_field = {}
    for name, (rows, _), img, ref, got in zip(fields, flat, imgs, want, lib):
        if not torch.equal(img, ref):
            raise AssertionError(f"untile_scatter ({tag}, {name}) disagrees "
                                 "with its plain version")
        if not torch.equal(got, ref):
            raise AssertionError(f"the untile yardstick ({tag}, {name}) "
                                 "disagrees with the plain version")
        es, C = rows.element_size(), rows.shape[3]
        n_bytes += n_read * tile ** 2 * C * es + img.numel() * es
        per_field[name] = {"shape": list(rows.shape),
                           "dtype": str(rows.dtype),
                           "strides": list(rows.stride())}
    del imgs, want, lib
    rec = {"fields": per_field, "launches_per_raster": 1,
           "ms": time_ms(lambda: fwd(*args)),
           "device_ms": device_ms(lambda: fwd(*args), "untile_kernel"),
           "plain_ms": time_ms(plain),
           "library_ms": time_ms(library),
           "library_device_ms": device_ms(library, None),
           **bound(n_bytes, 0)}
    print(f"[untile] {tag}: untile_scatter on {len(flat)} fields in "
          f"one launch, each "
          f"field equal to plain and to torch.take; {rec} ({card})",
          flush=True)
    return rec, n_read


def batch_phase(device, card: str) -> dict:
    import torch_renderer_tpu_torch as trt
    from torch_renderer_tpu_torch.apps import batch_render_bench
    from torch_renderer_tpu_torch.rasterize import cuda_hard
    from torch_renderer_tpu_torch.rasterize.binning import (
        set_budget_check_default,
    )
    from torch_renderer_tpu_torch.rasterize.geometry import setup_face_planes

    H, W = BATCH_SIZE
    # the app at its defaults; every count it launches is this run's
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    app = batch_render_bench.main([])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    peak_app = torch.cuda.max_memory_allocated() / 2**30
    calls = app["calls"]
    print(f"[batch] app at its defaults ({BATCH_VIEWS} views of {W}x{H}, "
          f"chunks of {BATCH_CHUNK}, bin {BATCH_TILE}, --check-budgets warn):"
          f" max_faces_per_bin {app['max_faces_per_bin']}, active_tiles "
          f"{app['active_tiles']}; "
          f"{app['images_per_s']:.1f} depth images/s batched, "
          f"{app['serial_images_per_s']:.1f} images/s serial single-view "
          f"(host clock over synchronized calls); {calls} render calls, "
          f"{wall_s:.1f} s in all; launches {counts}; peak device memory "
          f"{peak_app:.3f} GiB; {card}", flush=True)
    want = only(counts, hard_k1=calls, gather_tiles_fwd=calls,
                untile_scatter=calls)
    if counts != want:
        raise AssertionError(f"batch render: expected launches {want}, got "
                             f"{counts}")
    if not (0.05 < app["coverage"] < 0.9 and 1.5 < app["depth_max"] < 3.0):
        raise AssertionError(f"batch render: implausible depth (coverage "
                             f"{app['coverage']}, max {app['depth_max']})")

    set_budget_check_default("off")
    batched, R, t, K, kw = _batch_chunk(device, app)
    rp = trt.DepthRender(K, BATCH_SIZE, **kw)
    with torch.no_grad():
        # one call's launches, then the kernel's epilogue against the plain
        # one bit for bit
        torch.cuda.synchronize()
        reset_counts()
        dp, sp = rp.render(batched, R, t, return_silhouette=True)
        torch.cuda.synchronize()
        per_call = read_counts()
        fp_, _ = rp.rasterize(batched, R, t)
        with plain_epilogue():
            dx, sx = rp.render(batched, R, t, return_silhouette=True)
            fx_, _ = rp.rasterize(batched, R, t)
    print(f"[batch] one {BATCH_CHUNK}-view call launches {per_call}",
          flush=True)
    if per_call != only(per_call, hard_k1=1, gather_tiles_fwd=1,
                        untile_scatter=1):
        raise AssertionError("a batch render call must launch hard_k1, "
                             "gather_tiles_fwd and untile_scatter once "
                             f"each, got {per_call}")
    same = {"depth": bool(torch.equal(dp, dx)),
            "silhouette": bool(torch.equal(sp, sx)),
            **{n: bool(torch.equal(getattr(fp_, n), getattr(fx_, n)))
               for n in ("pix_to_face", "zbuf", "bary", "dists")}}
    print(f"[batch] untile kernel vs plain epilogue on one {BATCH_CHUNK}-view "
          f"call, bit-identical: {same}; coverage "
          f"{float((dp > 0).float().mean()):.4f}", flush=True)
    if not all(same.values()):
        raise AssertionError("the untile kernel's epilogue is not "
                             "bit-identical to its plain version")
    del dx, sx, fx_
    grad = _untile_backward_check(device)

    # the new kernels against their plain versions at this call's shapes
    st = rp.settings
    with torch.no_grad():
        fd = setup_face_planes(batched, rp.camera_with_pose(R, t))
        inp = cuda_hard.binned_inputs(fd, st)
        gather = gather_check("720p call slab", *_slab_gather_inputs(inp),
                              card, bwd=False)
        k1 = hard_k1_check("720p call slab", inp, st, card)
        bins, fields = cuda_hard.binned_tile_fields(fd, st)
    untile, n_read = untile_check("720p call", bins, fields, BATCH_SIZE,
                                  BATCH_TILE, card)
    del fields

    with torch.no_grad():
        call_ms = {}
        for run in ("kernel", "plain", "plain_2", "kernel_2"):
            with (plain_epilogue() if run.startswith("plain")
                  else contextlib.nullcontext()):
                call_ms[run] = time_ms(lambda: rp.render(batched, R, t),
                                       reps=10)
    print(f"[batch] one {BATCH_CHUNK}-view call by CUDA events, in turns "
          f"(budget checks off): {call_ms} ms ({card})", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        prof = _busy_share(lambda: [rp.render(batched, R, t)
                                    for _ in range(PROFILE_ITERS)],
                           PROFILE_ITERS, top=8)
    print(f"[batch] profile of {PROFILE_ITERS} {BATCH_CHUNK}-view calls "
          f"({card}): {prof}", flush=True)
    peak_call = torch.cuda.max_memory_allocated() / 2**30
    print(f"[batch] peak device memory over the profiled calls "
          f"{peak_call:.3f} GiB ({card})", flush=True)
    set_budget_check_default(None)
    return {"app": app, "counts": counts, "per_call": per_call,
            "gather": gather, "untile": untile, "n_read": n_read,
            "grad": grad, "call_ms": call_ms, "profile": prof, "hard_k1": k1,
            "peak_app_gb": peak_app, "peak_call_gb": peak_call}


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
    log = (lib_path.parent / "build.log").read_text()
    print(log, flush=True)
    ptxas = ptxas_report(log)
    for k, v in ptxas.items():
        if k.startswith(("soft_coverage", "hard_k1", "topk_select",
                         "points_select", "gather_fwd", "gather_bwd",
                         "untile_kernel", "texsample")):
            print(f"ptxas {k}: {v.get('registers')} registers, "
                  f"{v.get('smem')} bytes static smem, spill stores "
                  f"{v.get('spill_stores')} / loads {v.get('spill_loads')} "
                  "bytes", flush=True)

    soft_gather, kernels = soft_phase(device, card)
    hard = hard_phase(device, card)
    fits = {route: pose_fit_phase(device, card, route)
            for route in ("fragments", "pallas")}
    # the soft pair's entries: ptxas, and the pallas route's silhouette
    # slab (its launches are that route's 500 iterations)
    for entry, key in zip(kernels[:2], ("fwd", "bwd")):
        name = f"soft_coverage_{key}"
        entry["ptxas"] = ptxas.get(f"{name}_kernel")
        entry["launches_pose_fit"] = fits["pallas"]["counts"][name]
        entry["pose_fit_shape"] = {
            "shape": hard["soft"]["shape"], "live": hard["soft"]["live"],
            **{k: hard["soft"][key][k] for k in (
                "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by") + (SOFT_FWD_PAIR_KEYS if key == "fwd" else ())}}
    tex = texture_phase(device, card)
    joint = joint_fit_phase(device, card)
    pts = points_phase(device, card)
    batch = batch_phase(device, card)

    source = "torch_renderer_tpu_torch/csrc/hard_raster.cu"
    h1, k4, k50 = (hard[k] for k in ("hard_k1", "topk_select_k4",
                                     "topk_select_k50"))
    kernels += [
        {"name": "hard_k1", "route": "cuda", "source": source,
         "replaces": "torch_renderer_tpu/rasterize/pallas_hard.py:157",
         "also_replaces": "torch_renderer_tpu/rasterize/pallas_hard.py:611",
         "launches": fits["pallas"]["counts"]["hard_k1"],
         "max_abs_err": h1["max_abs_err"], "ms": h1["ms"],
         "device_ms": h1["device_ms"], "plain_ms": h1["plain_ms"],
         "bound_ms": h1["bound_ms"], "bound_by": h1["bound_by"],
         "bound_every_pair_ms": h1["bound_every_pair_ms"],
         "library_ms": None,
         "depth_call": {k: batch["hard_k1"][k] for k in (
             "shape", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
             "bound_every_pair_ms", "box_pairs", "pairs", "diff_px")},
         "launches_depth_app": batch["counts"]["hard_k1"],
         "ptxas": ptxas.get("hard_k1_kernel"),
         "pose_fit_profile": fits["pallas"]["profile"]},
        {"name": "topk_select", "route": "cuda", "source": source,
         "replaces": "torch_renderer_tpu/rasterize/pallas_hard.py:237",
         "launches": joint["counts"]["topk_select"],
         "launches_pose_fit": fits["fragments"]["counts"]["topk_select"],
         "max_abs_err": max(k4["max_abs_err"], k50["max_abs_err"],
                            joint["topk"]["max_abs_err"]),
         "ms": joint["topk"]["ms"], "device_ms": joint["topk"]["device_ms"],
         "plain_ms": joint["topk"]["plain_ms"],
         "bound_ms": joint["topk"]["bound_ms"],
         "bound_by": joint["topk"]["bound_by"], "library_ms": None,
         "bound_every_pair_ms": joint["topk"]["bound_every_pair_ms"],
         "box_pairs": {"k8_joint": joint["topk"]["box_pairs"],
                       "k4": k4["box_pairs"], "k50": k50["box_pairs"]},
         "pairs": {"k8_joint": joint["topk"]["pairs"],
                   "k4": k4["pairs"], "k50": k50["pairs"]},
         "k4_ms": k4["ms"], "k4_device_ms": k4["device_ms"],
         "k4_plain_ms": k4["plain_ms"],
         "k4_bound_ms": k4["bound_ms"], "k4_bound_by": k4["bound_by"],
         "k4_bound_every_pair_ms": k4["bound_every_pair_ms"],
         "k50_ms": k50["ms"], "k50_device_ms": k50["device_ms"],
         "k50_plain_ms": k50["plain_ms"],
         "k50_bound_ms": k50["bound_ms"], "k50_bound_by": k50["bound_by"],
         "k50_bound_every_pair_ms": k50["bound_every_pair_ms"],
         "diff_px": {"k8_joint": joint["topk"]["diff_px"],
                     "k4": k4["diff_px"], "k50": k50["diff_px"]},
         "ptxas": {k: v for k, v in ptxas.items()
                   if k.startswith("topk_select")},
         "pose_fit_profile": fits["fragments"]["profile"]},
    ]
    source = "torch_renderer_tpu_torch/csrc/texsample.cu"
    t, tf = tex["times"], joint["tex"]["times"]
    frag = {"shape": joint["tex"]["shape"],
            "live_points": joint["tex"]["live_points"],
            "texels": joint["tex"]["texels"]}
    kernels += [
        {"name": "texsample_fwd", "route": "cuda", "source": source,
         "replaces": "torch_renderer_tpu/ops/pallas_texsample.py:81",
         "launches": joint["counts"]["texsample_fwd"],
         "max_abs_err": max(tex["fwd_err"], joint["tex"]["fwd_err"]),
         "ms": t["fwd"], "device_ms": t["fwd_device"],
         "host_ms": t["fwd_host"], "plain_ms": t["fwd_plain"],
         "bound_ms": tex["bound_fwd"]["bound_ms"],
         "bound_by": tex["bound_fwd"]["bound_by"],
         "library_ms": t["fwd_library"],
         "library_device_ms": t["fwd_library_device"],
         "library_host_ms": t["fwd_library_host"],
         "shape": tex["shape"], "host_parts": tex["host_parts"],
         "fit_fragments": {**frag, **{k: tf["fwd" + sfx] for k, sfx in (
             ("ms", ""), ("device_ms", "_device"), ("host_ms", "_host"),
             ("plain_ms", "_plain"), ("library_ms", "_library"),
             ("library_device_ms", "_library_device"))},
             "bound_ms": joint["tex"]["bound_fwd"]["bound_ms"],
             "max_abs_err": joint["tex"]["fwd_err"]},
         "ptxas": {k: v for k, v in ptxas.items()
                   if k.startswith("texsample_fwd")}},
        {"name": "texsample_bwd", "route": "cuda", "source": source,
         "replaces": "torch_renderer_tpu/ops/pallas_texsample.py:100",
         "launches": joint["counts"]["texsample_bwd"],
         "max_abs_err": max(tex["bwd_err"], joint["tex"]["bwd_err"]),
         "ms": t["bwd"], "device_ms": t["bwd_device"],
         "all_device_ms": t["bwd_all_device"],
         "kernels_per_call": t["bwd_kernels_per_call"],
         "host_ms": t["bwd_host"], "plain_ms": t["bwd_plain"],
         "bound_ms": tex["bound_bwd"]["bound_ms"],
         "bound_by": tex["bound_bwd"]["bound_by"],
         "library_ms": t["bwd_library"],
         "library_device_ms": t["bwd_library_device"],
         "library_host_ms": t["bwd_library_host"], "shape": tex["shape"],
         "fit_fragments": {**frag, **{k: tf["bwd" + sfx] for k, sfx in (
             ("ms", ""), ("device_ms", "_device"),
             ("all_device_ms", "_all_device"), ("host_ms", "_host"),
             ("plain_ms", "_plain"), ("library_ms", "_library"),
             ("library_device_ms", "_library_device"))},
             "bound_ms": joint["tex"]["bound_bwd"]["bound_ms"],
             "max_abs_err": joint["tex"]["bwd_err"]},
         "joint_fit_profile": {k: v for k, v in joint["profile"].items()
                               if "texsample" in k or k.startswith("under_")
                               or k in ("busy_ms_per_iter",
                                        "kernels_per_iter")},
         "ptxas": {k: v for k, v in ptxas.items()
                   if k.startswith("texsample_bwd")}},
    ]
    ku, kp = pts["kernel"]["uniform"], pts["kernel"]["per_point"]
    kernels.append(
        {"name": "points_select", "route": "cuda",
         "source": "torch_renderer_tpu_torch/csrc/points_select.cu",
         "replaces": "torch_renderer_tpu/rasterize/pallas_points.py:62",
         "launches": pts["counts"]["points_select"],
         "max_abs_err": max(ku["max_abs_err"], kp["max_abs_err"]),
         "ms": ku["ms"], "device_ms": ku["device_ms"],
         "plain_ms": ku["plain_ms"], "bound_ms": ku["bound_ms"],
         "bound_by": ku["bound_by"], "library_ms": None,
         "bound_every_pair_ms": ku["bound_every_pair_ms"],
         "box_pairs": ku["box_pairs"], "pairs": ku["pairs"],
         "plan": ku["plan"], "max_per_tile": ku["max_per_tile"],
         "mean_per_tile": ku["mean_per_tile"],
         "per_point_ms": kp["ms"], "per_point_device_ms": kp["device_ms"],
         "per_point_plain_ms": kp["plain_ms"],
         "per_point_bound_ms": kp["bound_ms"],
         "per_point_bound_every_pair_ms": kp["bound_every_pair_ms"],
         "per_point_box_pairs": kp["box_pairs"],
         "per_point_plan": kp["plan"],
         "ptxas": ptxas.get("points_select_kernel")})
    g7, gs = batch["gather"], soft_gather
    source = "torch_renderer_tpu_torch/csrc/gather_tiles.cu"
    kernels += [
        {"name": "gather_tiles_fwd", "route": "cuda", "source": source,
         "replaces": "torch_renderer_tpu/rasterize/pallas_gather.py:129",
         "launches": batch["counts"]["gather_tiles_fwd"],
         "max_abs_err": max(g7["max_abs_err"], gs["max_abs_err"]),
         "ms": g7["ms"], "device_ms": g7["device_ms"],
         "plain_ms": g7["plain_ms"], "bound_ms": g7["bound_ms"],
         "bound_by": g7["bound_by"], "library_ms": g7["library_ms"],
         "library_device_ms": g7["library_device_ms"],
         "shape": g7["shape"], "soft_slab_ms": gs["ms"],
         "soft_slab_device_ms": gs["device_ms"],
         "soft_slab_plain_ms": gs["plain_ms"],
         "soft_slab_bound_ms": gs["bound_ms"],
         "soft_slab_library_ms": gs["library_ms"],
         "soft_slab_library_device_ms": gs["library_device_ms"],
         "launches_pose_fit": {r: f["counts"]["gather_tiles_fwd"]
                               for r, f in fits.items()},
         "fits_slabs": {k: {n: g[n] for n in (
             "shape", "live", "ms", "device_ms", "plain_ms", "bound_ms",
             "library_ms", "library_device_ms")}
             for k, g in hard["gathers"].items() if k != "floor"},
         "launch_floor": hard["gathers"]["floor"],
         "ptxas": {k: v for k, v in ptxas.items()
                   if k.startswith("gather_fwd")}},
        {"name": "gather_tiles_bwd", "route": "cuda", "source": source,
         "replaces": "torch_renderer_tpu/rasterize/pallas_gather.py:154",
         "launches": gs["launches_bwd"],
         "max_abs_err": gs["bwd"]["max_abs_err"], "tol": gs["bwd"]["tol"],
         "ms": gs["bwd"]["ms"], "device_ms": gs["bwd"]["device_ms"],
         "plain_ms": gs["bwd"]["plain_ms"],
         "bound_ms": gs["bwd"]["bound_ms"],
         "bound_by": gs["bwd"]["bound_by"],
         "library_ms": gs["bwd"]["library_ms"],
         "library_device_ms": gs["bwd"]["library_device_ms"],
         "shape": gs["shape"],
         "all_device_ms": gs["bwd"]["all_device_ms"],
         "kernels_per_call": gs["bwd"]["kernels_per_call"],
         "launches_pose_fit": fits["pallas"]["counts"]["gather_tiles_bwd"],
         "pallas_soft_slab": {k: hard["gathers"]["pallas_soft"]["bwd"][k]
                              for k in ("max_abs_err", "ms", "device_ms",
                                        "all_device_ms", "kernels_per_call",
                                        "plain_ms", "bound_ms",
                                        "library_ms", "library_device_ms")},
         "launch_floor": hard["gathers"]["floor"]["bwd"],
         "ptxas": {k: v for k, v in ptxas.items()
                   if k.startswith("gather_bwd")}},
    ]
    u, uf = batch["untile"], hard["untile"]
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
            "library_device_ms")
    kernels.append(
        {"name": "untile_scatter", "route": "cuda",
         "source": "torch_renderer_tpu_torch/csrc/untile.cu",
         "replaces": "torch_renderer_tpu/rasterize/pallas_untile.py:113",
         "launches": batch["counts"]["untile_scatter"], "max_abs_err": 0.0,
         **{k: u[k] for k in keys}, "bound_by": "bytes",
         "per_call_of": "the 4 fields of one 12-view 720p call",
         "launches_per_raster": u["launches_per_raster"],
         "launches_fits": {r: f["counts"]["untile_scatter"]
                           for r, f in fits.items()},
         "fits_shape": {k: uf[k] for k in keys},
         "ptxas": ptxas.get("untile_kernel")})
    app = batch["app"]
    print(f"batch depth render ({card}): {app['images_per_s']:.1f} images/s "
          f"batched, {app['serial_images_per_s']:.1f} serial; one call "
          f"{batch['call_ms']} ms", flush=True)
    print(f"point renders ({card}): " + ", ".join(
        f"{n} fwd {r['fwd_ms']:.3f} / grad {r['grad_ms']:.3f} ms"
        for n, r in pts["runs"].items()), flush=True)
    print(f"pose fit it/s ({card}): " + ", ".join(
        f"{r} {f['it_s_events']:.1f} (events) / {f['it_s_wall']:.1f} (wall)"
        for r, f in fits.items()), flush=True)
    print(f"joint fit it/s ({card}): {joint['it_s_events']:.1f} (events) / "
          f"{joint['it_s_wall']:.1f} (wall)", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

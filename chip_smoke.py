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
     1280x720, calls of 12 views, f = 0.9 * 720, bin 32, auto budgets and
     occupancy split, select_impl "affine", --check-budgets warn), eager
     and captured (its default: each call a replay of a CUDA graph), which
     must launch per call run from the host (every eager call; a graph's
     warm-up and capture) exactly one hard_k1, one gather_tiles_fwd and one
     untile_scatter (for the four fragment fields) and nothing else; the
     two forms' 120 views bit for bit, the captured first 12 within 2e-3
     of the float64 ray caster; a 12-view call as the app makes it in both
     forms, a replay's kernels against eager's (the profiler), each form's
     busy share and peak memory. On one 12-view call: the
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
  H. the loops as replays of captured CUDA graphs (utils/graph.py; on the
     card the default of the bench twin's step and of both fitters), each
     against its eager form (capture=False, which phases A, C and E run,
     since a replay advances no wrapper count). The bench twin's step:
     its forward captured alone gives step 0's alpha equal to eager's; 10
     chained steps in both forms, each step's g within 1e-5 of its
     largest; the twin's 5 passes in each form, in turns; 20 replays with
     any host synchronization raising (torch.cuda.set_sync_debug_mode);
     the device kernels of 20 steps in both forms by torch.profiler (the
     same count of each of the port's kernels, the same names of the rest,
     copies aside: same_kernels; every window opens with marker kernels
     that take the records a window can lose at its start, and one that
     recorded fewer kernels than its run launched is profiled again, up to
     3 windows a form). The
     pose fit on both routes and the joint fit at the apps' defaults, 500
     iterations, eager, captured, captured, eager, each held to phase C's
     or E's gates; the first captured fit launches each of its wrappers
     twice an iteration kind (its eager first iteration and the capture)
     and no other; a 22-iteration captured fit whose 21 replays run with
     host synchronization raising, and the device kernels of a
     22-iteration fit in both forms, as for the bench. Each form's img/s
     or it/s, busy share and peak device memory are printed.
  I. the depth-render apps through main() on the card:
     render_compare at its defaults (three views of the normalized level-3
     icosphere at 180x180, rendered by the port, written as a recording,
     read back, rendered again and held against the float64 ray caster:
     worst interior depth difference below 2e-3, the gate of the JAX
     package's tests/test_apps_smoke.py); quick_render (8 frames at
     256x256, 16 PNGs, coverage between 0.1 and 0.9); and
     object_pose_from_depth in both modes at 200 iterations (the captured
     fit; the loss falls and the translation error falls below 0.6x its
     start: 0.44x and 0.46x on the CPU). Each is
     counted: its mesh raster's kernels launched at least once.
  J. registration, pose search and the finite-difference pose fit, new in
     the slice that ported them: the icp_registration app at its defaults
     through main() (300 objects of 500 points sampled from the normalized
     level-3 icosphere, 100 iterations, captured: svd3 launched in each
     registration's eager first step and its capture, 4 in all, and no
     other kernel); its data eager and captured in turns, each with
     tests/test_pose_search.py::TestRegistration's gates (mean translation
     error < 1e-3 m, rotation error < 1e-2 rad), the eager run launching
     svd3 once a step and nothing else, the captured R, t, s within 1e-6
     of eager's, objects 0 and 1 within 1e-3 of the numpy solver; svd3 on
     the covariances of the first step against its plain Jacobi (u, s, vt
     within 1e-4) and torch.linalg.svd (the library call: the Umeyama
     rotation within 1e-5); replays without a host read, busy share and
     peak memory. The pose_search app at its defaults (400 hypotheses,
     elite 100, 10 iterations, its lobed 500-point cloud; no kernel of the
     port on this path): its best-score history non-increasing, its pose
     error printed; the search eager and captured in turns (equal within
     1e-5); search_batch on tests/test_pose_search.py's three targets
     (scores < 0.12); chamfer_eval at its defaults (1000 poses,
     corr(chamfer, translation error) > 0.3). The FD pose fit at 128^2
     (level-3 icosphere, tests/test_component_parity.py's start, step
     0.02, eps 2e-3, 100 steps) eager, captured, captured, eager: the
     final loss below the start's and the translation error down in each,
     captured params within 1e-6 of eager's, exactly two launches a step
     of hard_k1, gather_tiles_fwd and untile_scatter (the 12-view
     difference call and the 2-view accept call) counted eager and read
     off the profiler for the replays; then the three kernels against
     their plain versions at the 12-view call.
  K. the COCO data generator (datagen/coco.py), new in the slice that
     ported it: the coco_data_generator app through main() at its defaults
     (4 scenes x 25 views at 480x640, 2-5 primitives a scene, random
     materials, rest placement, normals, outputs packed on the card) and
     with --material-mode texture --room --placement physics --edge-maps
     --min-visible-px 200 at 3 scenes, each captured (the default: the
     chunk render and the visibility count replays of CUDA graphs) and
     --eager, each counted: exactly one hard_k1, gather_tiles_fwd and
     untile_scatter launch a chunk of 8 views and a visibility render run
     from the host (all of them eager; a graph's warm-up and capture),
     texsample_fwd at most once a chunk and at least once in the textured
     run; every annotation's area at least min_visible_px and its RLE
     covering 480 x 640 pixels; images/s, s a scene, the annotations, peak
     memory; the two forms' written datasets equal file for file (PNGs,
     depth, seg and normals arrays, annotations, poses). Then a scene of
     each configuration profiled in each form (busy share, the kernels'
     device ms), one chunk and one visibility count of a textured room scene in
     each form (a replay's kernels against eager's, by the profiler, in a
     process of its own and in this one; the chunk's device ms) and
     at that chunk hard_k1 (all 8 rows bit for bit; its plain version 2
     views at a time), gather_tiles_fwd and untile_scatter (equal) and
     texsample_fwd (within 1e-6; the backward on a seeded cotangent within
     1e-5 of its largest) against their plain versions, each timed with
     its bound and library call; the settle sim (5 bodies, 1500 steps)
     captured, captured, eager, eager (one Settler a form): within 1e-6,
     each form's repeat equal to its first run, no host read inside a
     replay nor in an eager settle; canny_edges on the card against the CPU on the chunk's rgb
     (grad_magnitude within 1e-4 of its largest, thresholded equal except
     where a comparison sits within that of its threshold, counted). The
     native library (native/*.cpp) is built by g++ into build/native/ and
     the run says whether it loaded; the app writes into build/coco_smoke/,
     removed afterwards.
  L. the multi-card layer (parallel/), new in the slice that ported it,
     through parallel.launch.run_ranks: NCCL with one rank a card over 4
     cards (2 with 2 or 3), or two gloo ranks on cuda:0 with one card
     (their times are a correctness run's, not scaling). On every rank: the face-sharded soft silhouette at the
     bench's scale (impl "pallas", faces split over a (1, 2) or (2, 2)
     mesh), alpha and the vertex gradient of its sum, exactly one
     soft_coverage_fwd, soft_coverage_bwd, gather_tiles_fwd and
     gather_tiles_bwd launch a call; one pass of the bench twin's
     multi-card branch (B=8 a rank, captured per rank); then over a
     (ranks, 1) mesh: register_batch_sharded at the app's size (300 x 500,
     100 iterations; svd3 launched), search and search_batch with a
     device_mesh at the pose_search app's defaults, render_points_sharded
     at the point bench scene (one points_select and one gather_tiles_fwd
     launch a call), the coco_data_generator app with the mesh at its
     defaults for 2 scenes (one hard_k1, gather_tiles_fwd and
     untile_scatter launch a chunk of 8 views on every rank; rank 0
     writes every image) and one scene's packed outputs, and
     data_parallel_fit (4 views at 128^2, 50 iterations; topk_select
     launched). Rank 0 also runs each path on one rank and holds: alpha
     within 2e-4 and the gradient within 1e-3 of its largest, ICP and the
     searches within 1e-5, the point render within 1e-5, the COCO outputs
     and annotations equal, the fit's first iteration within 1e-5 of the
     single-rank fit's and its history within 2e-3 (two single-rank fits
     on the card differ by up to 6.5e-4: float32 atomics), its loss
     falling. Each sharded call is timed by CUDA events on every rank.
     The kernels line gains a "sharded" key on each kernel launched here:
     its launches on every rank, by path.
  M. wide bins, new in the slice that took every bin size and K that the
     JAX package's binned paths take: the counted main path (the
     wrappers' launches also taken case by case, launches_into):
     soft_silhouette(tile=64, impl="pallas") and its gradient at the
     bench scene (alpha within 2e-4 of the dense oracle);
     rasterize_meshes at the pose scene with hard_k1 at tiles 48 and 64
     (the faces of tile 16) and topk_select at tile 64 K=4, tile 16 K=128
     and K=1000 (lists in device memory; its first 128 winners K=128's),
     each with the gradient of its depth; rasterize_points at the point
     bench scene at tile 64 K=8 and tile 16 K=65; the depth app at
     --bin-size 64 at its defaults, --eager (one hard_k1, gather and
     untile launch a call) and captured (one launch each a call run from
     the host; its 120 views bit for bit the eager run's); one call's 12
     views within 2e-3 of a float64 ray caster on the card, interior
     pixels; the pose app at --bin-size 64 on both
     routes at its defaults with a face budget of the whole mesh (the
     loss and the translation error below 0.1x their start; the pallas
     route's silhouette keeps its tile 16, as the JAX fitter's does). Every
     new shape must launch. Then each widened kernel against its plain
     version at those shapes (hard_k1's 8 rows bit for bit, also on one
     12-view call of the depth app at bin 64; winners identical, the soft
     pair within phase A's bounds) with events ms, alone ms, its launches
     in the main path's cases of that shape (WIDE_ROWS), its bound and
     the plain time; and
     the kernels at section 6's old shapes (old_shape_times, events and
     alone ms), which reach the kernels through the public wrappers only
     and so time a parent tree too.
  N. the deform app (apps/deform_from_pcd.py, BASELINE.json config 3) at
     its defaults (level 4, 1000 samples, 2000 iterations), captured (its
     default), and --eager for 500 iterations: every chamfer finite, the
     last below 0.5x the first, the fitted mesh within radius 1.5; the
     first two chamfers of the forms within 1e-4; its iterations a second
     as it prints them; a surface sampling as a StepGraph drawing what
     eager draws, call for call, consecutive replays differing; a fit of
     22 iterations in each form profiled (a replay's kernels against
     eager's, the int64 fills of the generator's prologue counted against
     the captures and replays, rng_prologue; busy share, peak memory);
     each app run's busy share is that form's profiled device ms an
     iteration times the run's iterations a second.
  O. the two-phase creator (opt/creator.py) at CreatorConfig's defaults
     (geometry 4000 steps of 1000 samples, colour 500 steps over 10 views
     at 128x128, K=4) from the level-4 icosphere onto the deform app's
     target coloured clip(0.5 + 0.5 v), captured, each phase counted, with
     the JAX tests' gates (chamfer to under half its start, the RGB error
     finite and falling, the OBJ export round-trips, colours in [0, 1]);
     the colour fit's topk_select, gather_tiles_fwd and untile_scatter
     against their plain versions on its own slab (the deformed mesh, its
     10 poses, the settings the fit resolves), with their launches in the
     captured colour phase; both phases eager over shorter windows against
     the captured ones; both phases' forms profiled.

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
kernel, torch.linalg.svd for svd3; each is timed by events and alone (the profiler's sum of every
kernel of the call). Any failure raises (exit code 1). The second-to-last
line is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}.

The build's -Xptxas -v report is printed in full, and the registers,
shared memory and spills of the soft pair, hard_k1_kernel,
topk_select_kernel, points_select_kernel, the gather pair, untile_kernel,
the texture pair's instances and svd3_kernel once more in a line each.
svd3 replaces no Pallas kernel (JAX's ICP takes XLA's SVD at
torch_renderer_tpu/ops/icp.py:68); its bound counts OPS_SVD3 operations
and BYTES_SVD3 bytes a matrix.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
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
    from torch_renderer_tpu_torch.ops import cuda_svd3, cuda_texsample
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
    cuda_svd3.SVD3_LAUNCHES = 0


def read_counts() -> dict:
    from torch_renderer_tpu_torch.ops import cuda_svd3, cuda_texsample
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
            "untile_scatter": cuda_untile.UNTILE_LAUNCHES,
            "svd3": cuda_svd3.SVD3_LAUNCHES}


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
    step, _ = bench.make_step(meshes, cam, SIGMA, cfg, capture=False)
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


def hard_k1_check(tag: str, inp, st, card: str,
                  views: int | None = None) -> dict:
    """hard_k1 against its plain version on one binned raster's inputs
    (cuda_hard.BinnedInputs): all 8 rows bit for bit; where they are not,
    the winners of the first views (ties or a fault) are reported before
    it raises. The plain version runs `views` views at a time where given
    (its (B, A, tile^2, Fmax) priority of a whole 720p call or COCO chunk
    takes tens of GB). Times by events, the profiler and the plain
    version, and its bound."""
    from torch_renderer_tpu_torch.rasterize import cuda_hard

    args = (inp.slab, inp.count, inp.origin, st.bin_size, inp.inv_s,
            st.blur_radius, st.znear, st.clip_bary)
    n = views or inp.slab.shape[0]

    def plain():
        return torch.cat([cuda_hard.hard_k1_reference(
            inp.slab[b:b + n], inp.count[b:b + n], inp.origin[b:b + n],
            *args[3:]) for b in range(0, inp.slab.shape[0], n)])

    def lanes(o):
        lane = torch.where(o[:, :, 6] > 0, o[:, :, 7], -1.0)
        return lane.round().to(torch.int32)[:, :, None]

    o_k, o_p = cuda_hard.hard_k1(*args), plain()
    torch.cuda.synchronize()
    same = bool(torch.equal(o_k, o_p))
    print(f"[hard] hard_k1 ({tag}) at the slab {tuple(inp.slab.shape)} "
          f"({int(inp.count.sum())} live slots, "
          f"{int((o_p[:, :, 6] > 0).sum())} covered pixels): all 8 rows "
          f"equal to plain: {same}", flush=True)
    if not same:
        prio = cuda_hard._priority(inp.slab[:n], inp.count[:n],
                                   inp.origin[:n], *args[3:7])
        _winner_check(f"hard_k1 ({tag}), first {n} views", lanes(o_k[:n]),
                      lanes(o_p[:n]), prio)
        raise AssertionError(f"hard_k1 ({tag}) disagrees with its plain "
                             "version")
    rec = {"max_abs_err": 0.0, "diff_px": 0, "shape": list(inp.slab.shape),
           "live": int(inp.count.sum()), "max_count": int(inp.count.max()),
           "ms": time_ms(lambda: cuda_hard.hard_k1(*args)),
           "device_ms": device_ms(lambda: cuda_hard.hard_k1(*args),
                                  "hard_k1_kernel"),
           "plain_ms": time_ms(plain, reps=3),
           **hard_bound(inp.slab, inp.count, inp.origin, 8, OPS_HARD_K1,
                        st.bin_size, inp.inv_s, st.blur_radius)}
    print(f"[hard] hard_k1 ({tag}) ({card}): {rec}", flush=True)
    return rec


def topk_check(tag: str, inp, st, exact: bool = False) -> dict:
    """topk_select against its plain version on one binned raster's inputs
    (cuda_hard.BinnedInputs) and settings: winners identical with exact,
    else equal or differing only at selection-depth ties (_winner_check);
    times by events, the profiler and the plain version, and its bound."""
    from torch_renderer_tpu_torch.rasterize import cuda_hard

    Kf, blur = st.faces_per_pixel, st.blur_radius
    slab, count, origin = inp.slab, inp.count, inp.origin
    args = (slab, count, origin, Kf, st.bin_size, inp.inv_s, blur, st.znear)
    print(f"[hard] topk_select {tag} (tile {st.bin_size}, K={Kf}, blur "
          f"{blur:.3e}) shapes: slab {tuple(slab.shape)}, max per tile "
          f"{int(count.max())}", flush=True)
    l_k = cuda_hard.topk_select(*args)
    l_p = cuda_hard.topk_select_reference(*args)
    torch.cuda.synchronize()
    prio = cuda_hard._priority(slab, count, origin, *args[4:8])
    gap, n_diff = _winner_check(f"topk_select {tag}", l_k, l_p, prio)
    del prio
    if exact and not bool(torch.equal(l_k, l_p)):
        raise AssertionError(f"topk_select {tag}: winners differ from the "
                             "plain version's")
    return {"max_abs_err": gap, "diff_px": n_diff,
            "ms": time_ms(lambda: cuda_hard.topk_select(*args)),
            "device_ms": device_ms(lambda: cuda_hard.topk_select(*args),
                                   "topk_select"),
            "plain_ms": time_ms(
                lambda: cuda_hard.topk_select_reference(*args)),
            "shape": list(slab.shape), "K": Kf, "tile": st.bin_size,
            **hard_bound(slab, count, origin, Kf, OPS_TOPK, st.bin_size,
                         inp.inv_s, blur)}


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
        out[f"topk_select_k{Kf}"] = topk_check(f"K={Kf}", inp, st)
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

def pose_setup(device, route: str, iters: int = POSE_ITERS):
    """The pose app's defaults on one route: (fitter, meshes, refs,
    params0, R_gt, t_gt, t0)."""
    from torch_renderer_tpu_torch.cameras.perspective import (
        PerspectiveCamera,
    )
    from torch_renderer_tpu_torch.opt.pose_fit import (
        CameraPoseFitter,
        PoseFitConfig,
        pose_params_from_Rt,
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
    return fitter, meshes, refs, params0, R_gt, t_gt, t0


def timed(fn):
    """(fn(), seconds by CUDA events, seconds by the host clock), the
    device idle at both ends."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t_start = time.perf_counter()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t_start
    return out, start.elapsed_time(stop) / 1000.0, wall_s


def pose_gates(tag: str, params, hist, t_gt, t0, iters: int) -> dict:
    """Phase C's gates: every loss finite, the loss and the translation
    error below 0.1x their start."""
    from torch_renderer_tpu_torch.opt.pose_fit import pose_params_to_Rt

    loss = hist["loss"].cpu().numpy()
    iou = hist["iou"].cpu().numpy()
    err0 = float(np.linalg.norm(t0 - t_gt))
    err1 = float(np.linalg.norm(pose_params_to_Rt(params)[1][0].cpu().numpy()
                                - t_gt))
    print(f"[{tag}] loss {loss[0]:.5f} -> {loss[-1]:.5f}, iou "
          f"{iou[0]:.3f} -> {iou[-1]:.3f}, translation error {err0:.4f} -> "
          f"{err1:.4f} m", flush=True)
    if not np.isfinite(loss).all() or loss.shape != (iters,):
        raise AssertionError(f"{tag}: a loss is not finite")
    if not loss[-1] < 0.1 * loss[0]:
        raise AssertionError(f"{tag}: the loss did not fall below 0.1x "
                             "its start")
    if not err1 < 0.1 * err0:
        raise AssertionError(f"{tag}: the translation error did not fall "
                             "below 0.1x its start")
    return {"loss": [float(loss[0]), float(loss[-1])], "err": [err0, err1]}


def pose_fit_phase(device, card: str, route: str,
                   iters: int = POSE_ITERS) -> dict:
    fitter, meshes, refs, params0, R_gt, t_gt, t0 = pose_setup(
        device, route, iters)
    reset_counts()
    (params, hist), events_s, wall_s = timed(
        lambda: fitter.fit(meshes, refs, params0, capture=False))
    counts = read_counts()
    st = fitter.renderer.resolved_settings(meshes, R_gt, t_gt)
    print(f"[fit {route}] {st}", flush=True)
    gates = pose_gates(f"fit {route}", params, hist, t_gt, t0, iters)
    print(f"[fit {route}] launches {counts}", flush=True)
    print(f"[fit {route}] {iters} iters: {iters / events_s:.1f} it/s by "
          f"CUDA events ({events_s * 1000.0 / iters:.4f} ms/iter), "
          f"{iters / wall_s:.1f} it/s by host wall time "
          f"({wall_s * 1000.0 / iters:.4f} ms/iter) on {card}", flush=True)
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
        meshes, refs, params, n_steps=PROFILE_ITERS, capture=False),
        PROFILE_ITERS, top=5,
        named=(("topk_select",) if route == "fragments" else
               ("hard_k1", "soft_coverage")) + ("gather_fwd",))
    print(f"[fit {route}] profile over {PROFILE_ITERS} iterations "
          f"({card}): {prof}", flush=True)
    return {"counts": counts, "it_s_events": iters / events_s, "profile": prof,
            "it_s_wall": iters / wall_s, **gates}


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
    busy_ms = _union_ms(events)
    out = {"kernels_per_iter": len(events) / iters,
           "busy_ms_per_iter": busy_ms / iters,
           "wall_ms_per_iter": wall_ms / iters,
           "busy_share": busy_ms / wall_ms}
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


def joint_setup(device, iters: int = JOINT_ITERS):
    """The joint app's defaults: (fitter, src, uvs, target, dataset)."""
    from torch_renderer_tpu_torch.apps._common import pinhole_K
    from torch_renderer_tpu_torch.apps.joint_shape_texture import (
        striped_target,
    )
    from torch_renderer_tpu_torch.ops.icosphere import icosphere
    from torch_renderer_tpu_torch.opt.deform_color import (
        JointFitConfig,
        JointShapeTextureFitter,
    )
    from torch_renderer_tpu_torch.rasterize.binning import (
        set_budget_check_default,
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
    return fitter, src, uvs, tgt, ds


def joint_gates(tag: str, src, tgt, params, hist, iters: int) -> dict:
    """Phase E's gates (the JAX package's tests/test_deform_color.py):
    every loss finite; the mean silhouette and RGB MSE of the last 20
    steps below 0.7x those of the first 20; max |deform| < 0.5; the chamfer
    distance to the target below 0.5x its start."""
    from torch_renderer_tpu_torch.ops.knn_chamfer import chamfer_distance
    from torch_renderer_tpu_torch.ops.sample_points import (
        sample_points_from_meshes,
    )

    h = {k: v.cpu().numpy() for k, v in hist.items()}
    sil, rgb = h["sil_mse"], h["rgb_mse"]
    sil0, sil1 = float(sil[:20].mean()), float(sil[-20:].mean())
    rgb0, rgb1 = float(rgb[:20].mean()), float(rgb[-20:].mean())
    max_deform = float(params["deform"].abs().max())

    def cham(mesh):
        gen = torch.Generator(device=src.device).manual_seed(7)
        a = sample_points_from_meshes(mesh, 2000, gen)
        b = sample_points_from_meshes(tgt, 2000, gen)
        return float(chamfer_distance(a, b)[0])

    c0, c1 = cham(src), cham(src.offset_verts(params["deform"]))
    print(f"[{tag}] sil MSE {sil0:.5f} -> {sil1:.5f}; rgb MSE {rgb0:.5f} -> "
          f"{rgb1:.5f} (means of the first / last 20 steps); max|deform| "
          f"{max_deform:.4f}; chamfer {c0:.6f} -> {c1:.6f}", flush=True)
    if not all(np.isfinite(v).all() for v in h.values()) \
            or sil.shape != (iters,):
        raise AssertionError(f"{tag}: a loss is not finite")
    if not (sil1 < 0.7 * sil0 and rgb1 < 0.7 * rgb0):
        raise AssertionError(f"{tag}: the silhouette or RGB MSE did not "
                             "fall below 0.7x its start")
    if not max_deform < 0.5:
        raise AssertionError(f"{tag}: vertex offsets exploded "
                             f"({max_deform})")
    if not c1 < 0.5 * c0:
        raise AssertionError(f"{tag}: chamfer {c0} -> {c1} did not fall "
                             "below 0.5x its start")
    return {"sil": [sil0, sil1], "rgb": [rgb0, rgb1], "chamfer": [c0, c1],
            "max_deform": max_deform}


def joint_fit_phase(device, card: str, iters: int = JOINT_ITERS) -> dict:
    from torch_renderer_tpu_torch.rasterize import cuda_hard
    from torch_renderer_tpu_torch.rasterize.binning import (
        count_active_tiles,
        count_overflow,
    )
    from torch_renderer_tpu_torch.rasterize.geometry import (
        setup_face_planes,
        setup_faces,
    )

    size = (JOINT_IMAGE, JOINT_IMAGE)
    fitter, src, uvs, tgt, ds = joint_setup(device, iters)
    reset_counts()
    (params, hist), events_s, wall_s = timed(lambda: fitter.fit(
        src, uvs, ds, torch.Generator().manual_seed(0), capture=False))
    counts = read_counts()
    gates = joint_gates("joint", src, tgt, params, hist, iters)
    final = src.offset_verts(params["deform"])
    print(f"[joint] launches {counts}", flush=True)
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
        n_steps=PROFILE_ITERS, params0=params, capture=False), PROFILE_ITERS,
        named=("topk_select", "texsample"),
        under=("TexSampleBackward", "ExpandBackward"))
    print(f"[joint] profile over {PROFILE_ITERS} iterations ({card}): "
          f"{prof}", flush=True)
    return {"counts": counts, "it_s_events": iters / events_s,
            "it_s_wall": iters / wall_s, **gates, "topk": topk, "tex": tex,
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


def points_select_check(tag: str, inp, st, card: str) -> dict:
    """points_select against its plain version on one binned point
    raster's inputs (cuda_points.PointInputs) and settings: winners
    identical; times by events, the profiler and the plain version, its
    bound (point_box_pairs) and the launcher's plan."""
    from torch_renderer_tpu_torch.rasterize import cuda_points

    args = (inp.slab, inp.count, inp.origin, inp.offs, st.points_per_pixel,
            st.znear, inp.r2)
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
    b = bound(n_bytes, n_box * OPS_POINTS + (live * tp - n_box) * OPS_BOX)
    every = bound(n_bytes, live * tp * OPS_POINTS)
    rec = {
        "max_abs_err": 0.0 if same else float("inf"),
        "shape": list(inp.slab.shape), "live": live, "K": Kp,
        "tile": math.isqrt(tp), "max_per_tile": int(inp.count.max()),
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
    print(f"[points] points_select {tag} at slab {rec['shape']}, K={Kp} "
          f"({live} live candidates, max {rec['max_per_tile']} per tile): "
          f"winners identical to plain: {same}; kernel {rec['ms']:.4f} ms "
          f"(device {rec['device_ms']} ms), plain {rec['plain_ms']:.4f} ms, "
          f"bound {b['bound_ms']:.6f} ms ({b['bound_by']}: {b['bytes']} B, "
          f"{b['ops']} op; {n_box} of {live * tp} live pairs in a splat's "
          f"box), every-pair bound {every['bound_ms']:.6f} ms; plan "
          f"(P, R, S) {rec['plan']} on {card}", flush=True)
    if not same:
        raise AssertionError(f"points_select ({tag}) disagrees with its "
                             "plain version")
    return rec


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
    kern = {name: points_select_check(f"{name} r^2", inp, st, card)
            for name, (inp, st) in slabs.items()}

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
    autotune.clear_cache()     # the twin resolves its DEFAULT row anew
    twin = point_twin(device, card)
    return {"counts": counts, "kernel": kern, "runs": runs, "rim": rim,
            "budgets": bud, "peak_gb": peak_gb, "profile": prof,
            "twin": twin}


# the point twin (torch_renderer_tpu_torch/bench_points.py) in phase F:
# chained steps a body in the forms' agreement run, and in each form's
# profiled window
TWIN_STEPS = 5
TWIN_WINDOW_STEPS = 3
TWIN_TOL = 1e-5      # captured against eager, relative to the largest |x|


def twin_body(name: str, body: str, fn, cloud, binned: bool,
              card: str) -> dict:
    """One twin row's body in both forms (bench_points.Chain, eager and
    captured): TWIN_STEPS chained steps each, from the same points, with
    each form's peak memory; the last outputs and the chain states held
    within TWIN_TOL of the largest |eager value| (and whether bit for
    bit); the wrapper launches (eager: one points_select and one
    gather_tiles_fwd a step on a binned row, none dense; captured: the
    warm-up's and the capture's, 2 each, however many replays, which run
    without a host sync); then a profiled window of TWIN_WINDOW_STEPS steps
    of each form, its kernels against the other's (same_kernels) and its
    busy share."""
    from torch_renderer_tpu_torch import bench_points as bp

    chains, rec = {}, {}
    for form, capture in (("eager", False), ("captured", True)):
        reset_counts()
        chain = chains[form] = bp.Chain(fn, cloud.points, capture)

        def run(chain=chain):
            out = None
            for _ in range(TWIN_STEPS):
                out = chain.step()
            return out.clone()

        with graph_calls() as graphs:
            out, peak = peak_mb(run)
        rec[form] = {"out": out, "c": chain.c.clone(),
                     "counts": read_counts(), "graphs": dict(graphs),
                     "peak_mb": peak}
    e, c = rec["eager"], rec["captured"]
    err = {k: float((c[k] - e[k]).abs().max()
                    / e[k].abs().max().clamp_min(1e-30))
           for k in ("out", "c")}
    bitwise = {k: bool(torch.equal(c[k], e[k])) for k in ("out", "c")}
    n = TWIN_STEPS if binned else 0
    want_e = only(e["counts"], points_select=n, gather_tiles_fwd=n)
    want_c = only(c["counts"], points_select=2 * binned,
                  gather_tiles_fwd=2 * binned)
    # TWIN_STEPS more steps of each form timed by events; the replays
    # launch nothing from the host and never sync
    ms = {}
    for form, block in (("eager", host_reads_raise),
                        ("captured", replays_without_sync)):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        with block() as n_replays:
            start.record()
            for _ in range(TWIN_STEPS):
                chains[form].step()
            stop.record()
        torch.cuda.synchronize()
        ms[form] = start.elapsed_time(stop) / TWIN_STEPS
    after = read_counts()
    finite = bool(torch.isfinite(e["out"]).all()
                  and torch.isfinite(c["out"]).all())
    expect = ({"points_select": TWIN_WINDOW_STEPS,
               "gather_tiles_fwd": TWIN_WINDOW_STEPS} if binned else {})
    kern = same_kernels(
        f"point twin {name} {body}",
        lambda captured: [chains["captured" if captured else "eager"].step()
                          for _ in range(TWIN_WINDOW_STEPS)], expect)
    for chain in chains.values():
        chain.release()
    row = {"rel_err": err, "bitwise": bitwise, "ms": ms,
           "launches": {k: {n_: v for n_, v in rec[k]["counts"].items() if v}
                        for k in rec},
           "graphs": rec["captured"]["graphs"],
           "peak_mb": {k: rec[k]["peak_mb"] for k in rec},
           "busy": kern["busy"], "kernels": kern["eager_kernels"],
           "captured_kernels": kern["captured_kernels"],
           "shape": list(e["out"].shape)}
    busy = {k: v["busy_ms"] / v["wall_ms"] for k, v in kern["busy"].items()}
    print(f"[point twin] {name} {body} ({card}): captured against eager "
          f"after {TWIN_STEPS} chained steps: output rel err "
          f"{err['out']:.2e} (bit for bit {bitwise['out']}), points rel err "
          f"{err['c']:.2e} (bit for bit {bitwise['c']}); launches eager "
          f"{row['launches']['eager']}, captured {row['launches']['captured']}"
          f" (graphs {row['graphs']}), then {n_replays[0]} replays without "
          f"a host sync; peak eager {row['peak_mb']['eager']:.1f} / captured "
          f"{row['peak_mb']['captured']:.1f} MiB; ms a step (events, "
          f"{TWIN_STEPS} steps) eager {ms['eager']:.4f} / captured "
          f"{ms['captured']:.4f}; busy share eager "
          f"{busy['eager']:.3f} / captured {busy['captured']:.3f} over "
          f"{TWIN_WINDOW_STEPS} steps; {kern['eager_kernels']} kernels",
          flush=True)
    fails = []
    if not finite:
        fails.append("a non-finite output")
    if max(err.values()) > TWIN_TOL:
        fails.append(f"captured differs from eager: {err}")
    if e["counts"] != want_e or c["counts"] != want_c:
        fails.append(f"launches eager {e['counts']} (want {want_e}), "
                     f"captured {c['counts']} (want {want_c})")
    # the timed eager steps launched as the first TWIN_STEPS did
    if (after != {k: c["counts"][k] + e["counts"][k] for k in after}
            or n_replays[0] != TWIN_STEPS):
        fails.append(f"replays launched from the host: {after}")
    if c["graphs"] != {"captures": 1, "replays": TWIN_STEPS - 1}:
        fails.append(f"graphs {c['graphs']}")
    if fails:
        raise AssertionError(f"point twin {name} {body}: "
                             + "; ".join(fails))
    return row


def _twin_launches(twin: dict, kernel: str) -> dict:
    """A wrapper's launches over the twin's bodies in phase F, by form
    (eager: one a step; captured: the warm-up's and the capture's)."""
    return {form: sum(r[b]["launches"][form].get(kernel, 0)
                      for r in twin["rows"].values() for b in r)
            for form in ("eager", "captured")}


def point_twin(device, card: str) -> dict:
    """The point twin (bench_points) at full width, every row, in both
    forms: twin_body for each row's forward and grad step, budget checks
    deferred as the twin defers them; then each form's busy share over
    the binned rows' windows and the largest peak."""
    from torch_renderer_tpu_torch import bench_points as bp
    from torch_renderer_tpu_torch.rasterize.binning import (
        deferred_budget_checks,
    )

    p = bp.FULL
    cloud, K, R, t = bp.scene(p["batch"], p["points"], p["image"], device)
    bud = bp.size_budgets(cloud, K, R, t, p["image"], device)
    renderers, auto = bp.make_renderers(cloud, K, R, t, p["image"], bud,
                                        device)
    print(f"[point twin] {p['batch']} x {p['points']} points at "
          f"{p['image']}^2, budgets {bud}, DEFAULT resolved to bin "
          f"{auto.bin_size}, {auto.max_points_per_bin} a bin, active tiles "
          f"{auto.active_tiles} ({card})", flush=True)
    rows = {}
    with deferred_budget_checks():
        for name, r in renderers.items():
            rows[name] = {body: twin_body(name, body, fn, cloud,
                                          name != bp.DENSE, card)
                          for body, fn in bp.bodies(r, cloud, R, t).items()}
    forms = {}
    for form in ("eager", "captured"):
        for body in bp.BODIES:
            binned = [rows[n][body]["busy"][form] for n in rows
                      if n != bp.DENSE]
            forms[f"{form} {body}"] = {
                "busy_share": (sum(b["busy_ms"] for b in binned)
                               / sum(b["wall_ms"] for b in binned)),
                "peak_mb": max(rows[n][body]["peak_mb"][form]
                               for n in rows)}
    bit = sorted(f"{n} {b}" for n in rows for b in rows[n]
                 if rows[n][b]["bitwise"]["out"])
    print(f"[point twin] busy share over the binned rows' windows and the "
          f"largest peak, by form and body ({card}): {forms}; bit for bit "
          f"captured against eager: {bit}", flush=True)
    return {"rows": rows, "forms": forms, "budgets": bud,
            "bit_for_bit": bit}


# ---------------------------------------------------------------------------
# G. the batched multi-view depth render (apps/batch_render_bench)
# ---------------------------------------------------------------------------

BATCH_SIZE = (720, 1280)
BATCH_VIEWS = 120
BATCH_CHUNK = 12
BATCH_TILE = 32


def _batch_chunk(device, app: dict, tile: int = BATCH_TILE):
    """One call's inputs at the app's defaults: the first 12 of its 120
    views of the normalized level-3 icosphere, and the app's settings with
    the budgets and the occupancy split it sized (for bin `tile`)."""
    import torch_renderer_tpu_torch as trt
    from torch_renderer_tpu_torch.apps._common import pinhole_K

    meshes = trt.Meshes.from_single(*trt.icosphere(LEVEL), device=device)
    meshes, _, _ = meshes.center_and_scale_to_unit_sphere()
    azims = np.linspace(0.0, 360.0, BATCH_VIEWS, endpoint=False)
    R, t = trt.look_at_view_transform(
        2.7, 15.0, torch.from_numpy(azims[:BATCH_CHUNK].astype(np.float32)))
    act = app["active_tiles"]
    kw = dict(pixel_chunk=1048576, bin_size=tile,
              max_faces_per_bin=app["max_faces_per_bin"],
              active_tiles=None if act < 0 else act,
              occupancy_split=app["occupancy_split"],
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


def batch_app_forms(card: str) -> dict:
    """The app at its defaults in both forms, each counted: eager (every
    call launches hard_k1, gather_tiles_fwd and untile_scatter once) and
    captured (each launches them once a call run from the host, the
    graphs' warm-ups and captures: "traced"); each form's rates, wall
    time and peak device memory, and its last pass's 120 views."""
    from torch_renderer_tpu_torch.apps import batch_render_bench

    H, W = BATCH_SIZE
    runs = {}
    for form in ("eager", "captured"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        app = batch_render_bench.main(
            ["--cards", "1"] + (["--eager"] if form == "eager" else []))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        calls, traced = app["calls"], app["traced"]
        print(f"[batch] app at its defaults, {form} ({BATCH_VIEWS} views of "
              f"{W}x{H}, chunks of {BATCH_CHUNK}, bin {BATCH_TILE}, "
              f"--check-budgets warn): max_faces_per_bin "
              f"{app['max_faces_per_bin']}, active_tiles "
              f"{app['active_tiles']}, occupancy_split "
              f"{app['occupancy_split']}; {app['images_per_s']:.1f} depth "
              f"images/s batched, {app['serial_images_per_s']:.1f} images/s "
              f"serial single-view (host clock over synchronized calls); "
              f"{calls} render calls, {traced} run from the host; "
              f"{wall_s:.1f} s in all; launches {counts}; peak device "
              f"memory {peak:.3f} GiB; {card}", flush=True)
        want = only(counts, hard_k1=traced, gather_tiles_fwd=traced,
                    untile_scatter=traced)
        if counts != want or (form == "eager") != (traced == calls):
            raise AssertionError(f"batch render {form}: expected launches "
                                 f"{want} ({calls} calls, {traced} from the "
                                 f"host), got {counts}")
        if not (0.05 < app["coverage"] < 0.9
                and 1.5 < app["depth_max"] < 3.0):
            raise AssertionError(f"batch render {form}: implausible depth "
                                 f"(coverage {app['coverage']}, max "
                                 f"{app['depth_max']})")
        runs[form] = {"app": app, "counts": counts, "wall_s": wall_s,
                      "peak_gb": peak}
    return runs


def batch_phase(device, card: str) -> dict:
    import io

    import torch_renderer_tpu_torch as trt
    from torch_renderer_tpu_torch.apps import render_compare
    from torch_renderer_tpu_torch.rasterize import cuda_hard
    from torch_renderer_tpu_torch.rasterize.binning import (
        set_budget_check_default,
    )
    from torch_renderer_tpu_torch.rasterize.geometry import setup_face_planes
    from torch_renderer_tpu_torch.utils.graph import CapturedCall

    forms = batch_app_forms(card)
    app, counts = forms["eager"]["app"], forms["eager"]["counts"]
    peak_app = forms["eager"]["peak_gb"]
    views = {f: r["app"].pop("views") for f, r in forms.items()}
    differ = int((views["captured"] != views["eager"]).sum())
    print(f"[batch] the {BATCH_VIEWS} views, captured against eager: "
          f"{differ} pixels differ ({card})", flush=True)
    if differ:
        raise AssertionError("the captured depth app's views are not the "
                             "eager app's bit for bit")
    # the captured app's first call against the float64 ray caster
    batched, R, t, K, kw = _batch_chunk(device, app)
    with torch.no_grad():
        mesh0 = batched.verts[0], batched.faces[0].long()
        ray = raycast_depth(*mesh0, K, R, t, BATCH_SIZE)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        worst = render_compare._diff_report(
            "depth app captured vs ray caster",
            views["captured"][:BATCH_CHUNK].cpu().numpy(), ray.cpu().numpy())
    del ray, views
    print(f"[batch] the captured app's first {BATCH_CHUNK} views against the "
          f"float64 ray caster: worst interior |diff| {worst:.6f} (tol "
          f"{RAY_TOL}) ({card})", flush=True)
    if not worst < RAY_TOL:
        raise AssertionError("captured depth app: depth is not within 2e-3 "
                             "of the ray caster")

    set_budget_check_default("off")
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

    # one call in both forms as the app makes it (a CapturedCall, the
    # depth copied into a kept buffer): the replay's kernels against
    # eager's, each form's busy share and peak memory
    keep = torch.empty((BATCH_CHUNK,) + BATCH_SIZE, device=device)
    calls = {f: CapturedCall(lambda R_, t_: rp.render(batched, R_, t_),
                             device, capture=f == "captured")
             for f in ("eager", "captured")}

    def run(captured: bool, n: int = PROFILE_ITERS):
        call = calls["captured" if captured else "eager"]
        with torch.no_grad():
            for _ in range(n):
                keep.copy_(call(R, t))

    run(True, 1)                  # the first call: warm-up and capture
    kern = same_kernels("depth call", run, {
        k: PROFILE_ITERS for k in ("hard_k1", "gather_tiles_fwd",
                                   "untile_scatter")})
    prof, peak_call = {}, {}
    for f in ("eager", "captured"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prof[f] = _busy_share(lambda: run(f == "captured"), PROFILE_ITERS,
                              top=8)
        peak_call[f] = torch.cuda.max_memory_allocated() / 2**30
        print(f"[batch] profile of {PROFILE_ITERS} {BATCH_CHUNK}-view calls, "
              f"{f} ({card}): {prof[f]}; peak device memory "
              f"{peak_call[f]:.3f} GiB", flush=True)
    for call in calls.values():
        call.release()
    set_budget_check_default(None)
    rates = {f: {k: r["app"][k] for k in ("images_per_s",
                                          "serial_images_per_s")}
             | {"wall_s": r["wall_s"], "peak_gb": r["peak_gb"],
                "busy_share": prof[f]["busy_share"],
                "launches": r["counts"], "traced": r["app"]["traced"],
                "calls": r["app"]["calls"]}
             for f, r in forms.items()}
    return {"app": app, "counts": counts, "per_call": per_call,
            "gather": gather, "untile": untile, "n_read": n_read,
            "grad": grad, "call_ms": call_ms, "profile": prof["eager"],
            "profile_captured": prof["captured"], "kernels": kern,
            "hard_k1": k1, "peak_app_gb": peak_app,
            "peak_call_gb": peak_call["eager"], "forms": rates,
            "views_differ": differ, "ray_worst": float(worst)}


# ---------------------------------------------------------------------------
# H. the loops as replays of captured CUDA graphs, against their eager form
# ---------------------------------------------------------------------------

# the device kernel of each wrapper count, by the name a profiler reads
DEVICE_NAMES = {"soft_coverage_fwd": "soft_coverage_fwd_kernel",
                "soft_coverage_bwd": "soft_coverage_bwd_kernel",
                "hard_k1": "hard_k1_kernel",
                "topk_select": "topk_select_kernel",
                "texsample_fwd": "texsample_fwd",
                "texsample_bwd": "texsample_bwd",
                "points_select": "points_select_kernel",
                "gather_tiles_fwd": "gather_fwd_kernel",
                "gather_tiles_bwd": "gather_bwd_kernel",
                "untile_scatter": "untile_kernel",
                "svd3": "svd3_kernel"}


@contextlib.contextmanager
def graph_calls():
    """Counts the CUDA graph captures (capture_begin) and replays made in
    the block: yields {"captures": n, "replays": m}."""
    cls = torch.cuda.CUDAGraph
    begin, replay = cls.capture_begin, cls.replay
    n = {"captures": 0, "replays": 0}

    def counted_begin(self, *args, **kw):
        n["captures"] += 1
        return begin(self, *args, **kw)

    def counted_replay(self):
        n["replays"] += 1
        return replay(self)

    cls.capture_begin, cls.replay = counted_begin, counted_replay
    try:
        yield n
    finally:
        cls.capture_begin, cls.replay = begin, replay


# marker kernels (int16 fills) that open every profiler window, before the
# call it counts: a window can lose the records of the first kernels after
# the profiler starts (PERF.md section 7); the markers take that loss, and
# are left out of the counts
WINDOW_MARKS = 256
MARK_NAME = "FillFunctor<short>"


def kernel_counts(fn) -> dict:
    """The device kernels of one call of fn() by torch.profiler: every
    kernel by short name, the port's kernels by wrapper, the CUDA graph
    captures and replays the call made (graph_calls), and how many of the
    window's WINDOW_MARKS opening markers it recorded ("marks")."""
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    marks = torch.empty(WINDOW_MARKS, dtype=torch.int16, device="cuda")
    torch.cuda.synchronize()
    with graph_calls() as graphs, profile(
            activities=[ProfilerActivity.CPU,
                        ProfilerActivity.CUDA]) as prof:
        for i in range(WINDOW_MARKS):
            marks[i].fill_(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not e.name.startswith(("Optimizer.", "ProfilerStep"))]
    n_marks = sum(MARK_NAME in e.name for e in events)
    events = [e for e in events if MARK_NAME not in e.name]
    names = [e.name for e in events]
    return {"all": collections.Counter(_short(n) for n in names),
            "ours": {k: sum(v in n for n in names)
                     for k, v in DEVICE_NAMES.items()},
            "graphs": dict(graphs), "marks": n_marks,
            "busy_ms": _union_ms(events), "wall_ms": wall_ms}


def _union_ms(events) -> float:
    """The device time covered by the events' spans (their union), ms."""
    busy_us, end = 0.0, -math.inf
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us / 1e3


def full_window(fn, expect: dict) -> dict:
    """kernel_counts(fn), profiled again, up to PROFILE_WINDOWS windows,
    while the window kept none of its opening markers or recorded fewer
    of one of the port's kernels than expect holds (a profiler drop:
    PERF.md section 7); the last window is returned, and its gate is the
    caller's."""
    for _ in range(PROFILE_WINDOWS):
        win = kernel_counts(fn)
        if win["marks"] and all(win["ours"][k] >= v
                                for k, v in expect.items()):
            break
    return win


def _rest(counts: dict, prologue=None) -> dict:
    """A window's kernel counts by name, copies left out (a graph runs a
    device-to-device copy as a kernel of another name, and the bench's
    captured step adds a copy into its static buffer), and the names that
    hold prologue's name (rng_prologue: compared apart, by their sum)."""
    return {n: c for n, c in counts.items() if "memcpy" not in n.lower()
            and not (prologue and prologue["name"] in n)}


def _prologue_sum(window: dict, prologue: dict) -> int:
    return sum(c for n, c in window["all"].items() if prologue["name"] in n)


def _prologue_added(window: dict, prologue: dict) -> int:
    """The prologue kernels the window's captures and replays add."""
    g = window.get("graphs", {})
    return (prologue["per_capture"] * g.get("captures", 0)
            + prologue["per_replay"] * g.get("replays", 0))


def _allowance(count: int) -> float:
    """The events of one count a profiler window may drop: max(2, 1%)."""
    return max(2, 0.01 * count)


def _falls_short(window: dict, other: dict, expect: dict,
                 prologue=None) -> bool:
    """Whether a profiler window recorded fewer events than its run
    launched: none of its opening markers (the loss may reach the call's
    own records), fewer of one of the port's kernels than the run's
    wrapper launches (expect), fewer kernels in all than the other form's
    window by more than the gate's allowance, or fewer of one name than
    the other form's window by more than it; with prologue, its name's
    kernels are counted with each window's graphs' prologue taken off."""
    mine, theirs = (_rest(w["all"], prologue) for w in (window, other))
    total, mine_total = sum(theirs.values()), sum(mine.values())
    if prologue:
        # the fills of the step itself, each window's graphs' prologue
        # taken off
        mine[prologue["name"]], theirs[prologue["name"]] = (
            _prologue_sum(w, prologue) - _prologue_added(w, prologue)
            for w in (window, other))
    return (window.get("marks", WINDOW_MARKS) == 0
            or any(window["ours"][k] < v for k, v in expect.items())
            or mine_total < total - _allowance(total)
            or any(mine.get(n, 0) < c - _allowance(c)
                   for n, c in theirs.items()))


# profiler windows a form may take before the gate compares them
PROFILE_WINDOWS = 3
# the kernels a CUDA graph that draws from a registered generator
# (CUDAGraph.register_generator_state) launches besides its step's: the
# generators' seeds and offsets written on the device, int64 fills, at its
# capture and before each replay (counted by rng_prologue)
RNG_FILL = "FillFunctor<long>"


def rng_prologue(device, card: str) -> dict:
    """The RNG_FILL kernels that a graph drawing from one registered
    torch.Generator adds at its capture and at each replay, measured: a
    StepGraph of one torch.rand draw, warmed up outside the windows, its
    capture and 1 replay in one window; a new one's capture and 5 replays
    in another. Each window is profiled PROFILE_WINDOWS times, each time
    with a new graph, and the most fills it recorded stand for it: a
    profiler window may drop records (PERF.md section 7) and never adds
    one. {"name": RNG_FILL, "per_capture": a, "per_replay": b}."""
    from torch_renderer_tpu_torch.utils.graph import StepGraph

    fills, graphs, seen = [], [], []
    for n in (1, 5):
        tries = []
        for _ in range(PROFILE_WINDOWS):
            g = torch.Generator(device=device).manual_seed(0)
            out = torch.empty(256, device=device)
            step = StepGraph(
                lambda g=g, out=out: out.copy_(torch.rand(
                    256, device=device, generator=g)), device, True, (g,))
            step()                      # the eager warm-up
            win = kernel_counts(lambda step=step, n=n: [step()
                                                        for _ in range(n)])
            step.release()
            tries.append((_prologue_sum(win, {"name": RNG_FILL}),
                          win["marks"]))
            graphs.append(win["graphs"])
        fills.append(max(f for f, _ in tries))
        seen.append(tries)
    per_replay, rem = divmod(fills[1] - fills[0], 4)
    rec = {"name": RNG_FILL, "per_capture": fills[0] - per_replay,
           "per_replay": per_replay, "fills": fills,
           "windows": seen}
    print(f"[rng prologue] int64 fills of a graph drawing from a registered "
          f"generator: {rec} (windows: [fills, opening markers kept] of "
          f"each profile; {card})", flush=True)
    want = ([{"captures": 1, "replays": 1}] * PROFILE_WINDOWS
            + [{"captures": 1, "replays": 5}] * PROFILE_WINDOWS)
    if (rem or per_replay < 1 or rec["per_capture"] < 0 or graphs != want):
        raise AssertionError(f"the RNG prologue is not a fixed count a "
                             f"capture and a replay: {rec}, graphs {graphs}")
    return rec


def same_kernels(tag: str, run, expect: dict, prologue=None) -> dict:
    """Gate: the captured run put the eager run's kernels on the device:
    the port's kernels count for count, every other kernel name for name,
    its count within the few events a profiler window drops (max(2, 1%)).
    prologue (rng_prologue's record): the kernels whose names hold its
    name are compared by their sum, the captured window's equal to the
    eager window's plus what its captures and replays add (per_capture a
    capture, per_replay a replay), within the same allowance.
    run(captured) runs one form; kernel_counts profiles it. A window that
    falls short of the launches its run made (_falls_short: expect holds
    the port's kernels' launches; or short of the other form's window, in
    all or in one name, by more than the allowance) is profiled again, up
    to PROFILE_WINDOWS windows a form, and only then are the two
    compared; the record keeps each short window's totals. Copies are
    left out (_rest)."""
    win = {k: kernel_counts(lambda c=c: run(c))
           for k, c in (("eager", False), ("captured", True))}
    short = []
    for _ in range(PROFILE_WINDOWS - 1):
        redo = [k for k in win
                if _falls_short(win[k], win[{"eager": "captured",
                                             "captured": "eager"}[k]],
                                expect, prologue)]
        if not redo:
            break
        for k in redo:
            short.append({"form": k, "ours": dict(win[k]["ours"]),
                          "kernels": sum(_rest(win[k]["all"]).values())})
            print(f"[{tag}] the {k} window fell short of its launches "
                  f"({short[-1]}; expected {expect}): profiled again",
                  flush=True)
            win[k] = kernel_counts(lambda c=(k == "captured"): run(c))
    eager, captured = win["eager"], win["captured"]

    e, c = _rest(eager["all"], prologue), _rest(captured["all"], prologue)
    diff = {n: (e.get(n, 0), c.get(n, 0)) for n in set(e) | set(c)
            if e.get(n, 0) != c.get(n, 0)}
    far = {n: ec for n, ec in diff.items()
           if abs(ec[0] - ec[1]) > _allowance(ec[0])}
    rng = None
    if prologue:
        want = (_prologue_sum(eager, prologue)
                + _prologue_added(captured, prologue)
                - _prologue_added(eager, prologue))
        rng = {"eager": _prologue_sum(eager, prologue),
               "captured": _prologue_sum(captured, prologue), "want": want,
               "graphs": {k: d.get("graphs") for k, d in
                          (("eager", eager), ("captured", captured))}}
        if abs(rng["captured"] - want) > _allowance(want):
            far[prologue["name"]] = (want, rng["captured"])
    copies = {k: {n: v for n, v in d["all"].items()
                  if n not in _rest(d["all"])}
              for k, d in (("eager", eager), ("captured", captured))}
    print(f"[{tag}] device kernels: eager {sum(e.values())} of {len(e)} "
          f"names, captured {sum(c.values())}, copies {copies}; ours eager "
          f"{eager['ours']}, captured {captured['ours']}; counts that "
          f"differ {dict(sorted(diff.items())[:12])}"
          + (f"; {prologue['name']} (the graphs' RNG prologue) {rng}"
             if prologue else ""),
          flush=True)
    if far or eager["ours"] != captured["ours"]:
        raise AssertionError(f"{tag}: the captured run's kernels are not "
                             f"the eager run's: {far}")
    return {"eager_kernels": sum(e.values()),
            "captured_kernels": sum(c.values()), "names": len(e),
            "ours": captured["ours"], "count_diff": diff, "copies": copies,
            "short_windows": short, "prologue": rng,
            "busy": {k: {m: w.get(m) for m in ("busy_ms", "wall_ms")}
                     for k, w in (("eager", eager),
                                  ("captured", captured))}}


@contextlib.contextmanager
def replays_without_sync():
    """From the first CUDA graph replay inside the block to its end, any
    host synchronization raises (torch.cuda.set_sync_debug_mode("error"));
    yields the count of replays."""
    graph_cls = torch.cuda.CUDAGraph
    saved = graph_cls.replay
    before = torch.cuda.get_sync_debug_mode()
    n = [0]

    def replay(self):
        torch.cuda.set_sync_debug_mode("error")
        n[0] += 1
        return saved(self)

    graph_cls.replay = replay
    try:
        yield n
    finally:
        graph_cls.replay = saved
        torch.cuda.set_sync_debug_mode(before)


@contextlib.contextmanager
def host_reads_raise():
    """Any host synchronization inside the block raises
    (torch.cuda.set_sync_debug_mode("error")); yields [0], the replay
    count of an eager block, for symmetry with replays_without_sync."""
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield [0]
    finally:
        torch.cuda.set_sync_debug_mode(before)


def peak_mb(fn):
    """(fn(), the peak device memory allocated during it above what was
    allocated before it, MiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - start) / 2**20


def captured_bench(device, card: str) -> dict:
    """The bench twin's step, eager and captured."""
    import torch_renderer_tpu_torch as trt
    from torch_renderer_tpu_torch import bench
    from torch_renderer_tpu_torch.utils.graph import StepGraph

    meshes, cam = bench.scene(B, IMAGE, LEVEL, device)
    size = (IMAGE, IMAGE)
    cfg = trt.suggest_soft_config(trt.setup_face_planes(meshes, cam), size,
                                  sigma=SIGMA, layout="packed")
    steps = {"eager": bench.make_step(meshes, cam, SIGMA, cfg,
                                      capture=False)[0],
             "captured": bench.make_step(meshes, cam, SIGMA, cfg,
                                         capture=True)[0]}

    # step 0's alpha: the step's forward, captured alone, equals eager's
    def alpha():
        return trt.soft_silhouette_fd(trt.setup_face_planes(meshes, cam),
                                      size, sigma=SIGMA, check_budgets="off",
                                      **cfg.kwargs())

    fwd = StepGraph(alpha, device, capture=True)
    a_eager, _ = alpha(), fwd()
    a_captured = fwd().clone()
    if not torch.equal(a_captured, a_eager):
        raise AssertionError("captured step 0 alpha differs from eager's: "
                             f"{float((a_captured - a_eager).abs().max())}")

    # the chained steps: each step's g within 1e-5 of its largest
    reset_counts()
    v = {k: meshes.verts for k in steps}
    g_err = []
    for _ in range(10):
        g = {}
        for k, step in steps.items():
            v[k], gk = step(v[k])
            g[k] = gk.clone()
        g_err.append(float((g["captured"] - g["eager"]).abs().max()
                           / g["eager"].abs().max()))
    counts = read_counts()
    print(f"[captured bench] 10 chained steps: max|g captured - g eager| / "
          f"max|g eager| per step {['%.2e' % e for e in g_err]}; launches "
          f"(10 eager steps, one captured warm-up and its capture) {counts}",
          flush=True)
    if not max(g_err) <= 1e-5:
        raise AssertionError("captured bench: g differs from eager's")
    if counts != only(counts, soft_coverage_fwd=12, soft_coverage_bwd=12,
                      gather_tiles_fwd=12, gather_tiles_bwd=12):
        raise AssertionError(f"captured bench: launches {counts}")

    # the passes, eager and captured in turns
    rates = {k: [] for k in steps}
    for i in range(PASSES):
        for k in (("eager", "captured") if i % 2 == 0
                  else ("captured", "eager")):
            r, v[k] = bench.time_passes(steps[k], v[k], B, STEPS, WARMUP, 1)
            rates[k] += r
    # the peak device memory of a new step's first pass (the capture, and
    # the graph's pool, included)
    peak = {}
    for k in steps:
        def first_pass():
            step, _ = bench.make_step(meshes, cam, SIGMA, cfg,
                                      capture=k == "captured")
            return bench.time_passes(step, meshes.verts, B, STEPS, WARMUP, 1)

        _, peak[k] = peak_mb(first_pass)
    with replays_without_sync() as n:
        for _ in range(PROFILE_ITERS):
            v["captured"], _ = steps["captured"](v["captured"])
    if n[0] != PROFILE_ITERS:
        raise AssertionError(f"captured bench: {n[0]} replays")
    kern = same_kernels(
        "captured bench",
        lambda c: [steps["captured" if c else "eager"](
            v["captured" if c else "eager"]) for _ in range(PROFILE_ITERS)],
        {k: PROFILE_ITERS for k in ("soft_coverage_fwd", "soft_coverage_bwd",
                                    "gather_tiles_fwd", "gather_tiles_bwd")})
    prof = {k: _busy_share(lambda: [steps[k](v[k])
                                    for _ in range(PROFILE_ITERS)],
                           PROFILE_ITERS) for k in steps}
    out = {}
    for k in steps:
        out[k] = {"img_s": statistics.median(rates[k]), "passes": rates[k],
                  "peak_mb": peak[k], **prof[k]}
        print(f"[captured bench] {k}: passes " + ", ".join(
            f"{r:.1f}" for r in rates[k]) + f" img/s, median "
            f"{out[k]['img_s']:.1f}, spread {min(rates[k]):.1f}-"
            f"{max(rates[k]):.1f}; busy {prof[k]['busy_ms_per_iter']:.4f} ms "
            f"of {prof[k]['wall_ms_per_iter']:.4f} wall ms a step (share "
            f"{prof[k]['busy_share']:.3f}), {prof[k]['kernels_per_iter']} "
            f"kernels a step; peak {peak[k]:.1f} MiB above the start of a "
            f"new step's first pass ({card})", flush=True)
    if not bool(torch.isfinite(v["captured"]).all()):
        raise AssertionError("captured bench: non-finite vertices")
    return {**out, "g_rel_err": g_err, "launches": counts, "kernels": kern}


def captured_fits(device, card: str, run_fit, gates, n_profile: int,
                  tag: str, want: dict) -> dict:
    """One fit eager and captured in turns (eager, captured, captured,
    eager), each at the app's iterations with phase C's or E's gates
    (gates(params, hist)); run_fit(capture, n) runs it. The counted run:
    the first captured fit launches each wrapper twice an iteration kind
    (its eager warm-up iteration and the capture), and no replay counts.
    Then the captured fit's replays without a host sync, and the kernels
    of an n_profile-iteration fit in both forms."""
    runs = {"eager": [], "captured": []}
    counts = None
    for k in ("eager", "captured", "captured", "eager"):
        if k == "captured" and counts is None:
            reset_counts()
        ((params, hist), events_s, wall_s), mb = peak_mb(
            lambda: timed(lambda: run_fit(k == "captured", None)))
        if k == "captured" and counts is None:
            counts = read_counts()
        n = hist["loss"].shape[0]
        g = gates(f"{tag} {k}", params, hist)
        del params, hist
        after = torch.cuda.memory_allocated() / 2**20
        runs[k].append({"it_s_events": n / events_s, "it_s_wall": n / wall_s,
                        "peak_mb": mb, "allocated_after_mb": after, **g})
        print(f"[{tag} {k}] {n} iters: {n / events_s:.1f} it/s by CUDA "
              f"events, {n / wall_s:.1f} by host wall time; peak {mb:.1f} "
              f"MiB above its start, allocated after it {after:.1f} MiB "
              f"({card})",
              flush=True)
    twice = only(counts, **{key: 2 * v for key, v in want.items()})
    if counts != twice:
        raise AssertionError(f"{tag}: captured launches {counts}, expected "
                             f"{twice}")
    with replays_without_sync() as n_rep:
        run_fit(True, n_profile)
    if n_rep[0] != n_profile - 1:
        raise AssertionError(f"{tag}: {n_rep[0]} replays of "
                             f"{n_profile} iterations")
    kern = same_kernels(tag, lambda c: run_fit(c, n_profile),
                        {k: n_profile * v for k, v in want.items() if v})
    prof = {k: _busy_share(lambda: run_fit(k == "captured", n_profile),
                           n_profile) for k in runs}
    # both forms run the same kernels (above), so the eager profile's busy
    # time an iteration over each timed run's wall time an iteration is
    # that run's busy share, warm-up and capture amortized over 500
    busy = prof["eager"]["busy_ms_per_iter"]
    for k in runs:
        for r in runs[k]:
            r["busy_share"] = busy * r["it_s_wall"] / 1e3
        print(f"[{tag} {k}] profile of a {n_profile}-iteration fit (its "
              f"first iteration and the capture included): busy "
              f"{prof[k]['busy_ms_per_iter']:.4f} ms of "
              f"{prof[k]['wall_ms_per_iter']:.4f} wall ms an iteration "
              f"(share {prof[k]['busy_share']:.3f}), "
              f"{prof[k]['kernels_per_iter']} kernels an iteration; timed "
              f"runs' busy share " + ", ".join(
                  f"{r['busy_share']:.3f}" for r in runs[k]) + f" ({card})",
              flush=True)
    return {"runs": runs, "launches": counts, "kernels": kern,
            "profile": prof}


def captured_phase(device, card: str) -> dict:
    """H: the bench twin's step, the pose fit on both routes and the joint
    fit, each eager and as replays of a captured CUDA graph, in turns."""
    out = {"bench": captured_bench(device, card)}
    for route in ("fragments", "pallas"):
        fitter, meshes, refs, params0, _, t_gt, t0 = pose_setup(device,
                                                                route)
        out[f"pose_{route}"] = captured_fits(
            device, card,
            lambda c, n: fitter.fit(meshes, refs, params0, n_steps=n,
                                    capture=c),
            lambda tag, p, h: pose_gates(tag, p, h, t_gt, t0, POSE_ITERS),
            PROFILE_ITERS + 2, f"captured pose {route}",
            {"topk_select": 1, "gather_tiles_fwd": 1, "untile_scatter": 1}
            if route == "fragments" else
            {"hard_k1": 1, "soft_coverage_fwd": 1, "soft_coverage_bwd": 1,
             "gather_tiles_fwd": 2, "gather_tiles_bwd": 1,
             "untile_scatter": 1})
    fitter, src, uvs, tgt, ds = joint_setup(device)
    out["joint"] = captured_fits(
        device, card,
        lambda c, n: fitter.fit(src, uvs, ds, torch.Generator().manual_seed(0),
                                n_steps=n, capture=c),
        lambda tag, p, h: joint_gates(tag, src, tgt, p, h, JOINT_ITERS),
        PROFILE_ITERS + 2, "captured joint",
        {"texsample_fwd": 1, "texsample_bwd": 1, "topk_select": 1,
         "gather_tiles_fwd": 1, "untile_scatter": 1})
    return out


# ---------------------------------------------------------------------------
# I. the depth-render apps
# ---------------------------------------------------------------------------

def depth_apps_phase(device, card: str) -> dict:
    """I: render_compare (the port's DepthRender against the float64 ray
    caster, at its defaults), quick_render and object_pose_from_depth (its
    captured fit), each through main() on the card, each counted."""
    import tempfile

    from torch_renderer_tpu_torch.apps import (
        object_pose_from_depth,
        quick_render,
        render_compare,
    )
    from torch_renderer_tpu_torch.rasterize.binning import (
        set_budget_check_default,
    )

    out = {}
    reset_counts()
    rc = render_compare.main([])
    counts = read_counts()
    print(f"[render_compare] worst interior |diff| {rc['worst']:.6f} (tol "
          f"2e-3); stages {rc['stages']}; launches {counts}", flush=True)
    if not rc["worst"] < 2e-3 or not np.isfinite(rc["ours"]).all():
        raise AssertionError("render_compare: the port's depth is not "
                             "within 2e-3 of the ray caster")
    if min(counts[k] for k in ("hard_k1", "gather_tiles_fwd",
                               "untile_scatter")) < 1:
        raise AssertionError(f"render_compare: launches {counts}")
    out["render_compare"] = {"worst": float(rc["worst"]),
                             "stages_s": rc["stages"], "launches": counts}

    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        qr = quick_render.main(["--out-dir", tmp])
        n_png = len([f for f in os.listdir(tmp) if f.endswith(".png")])
    counts = read_counts()
    print(f"[quick_render] {n_png} PNGs, coverage {qr['coverage']:.3f}, "
          f"depth max {qr['depth_max']:.3f}; launches {counts}", flush=True)
    if n_png != 16 or not 0.1 < qr["coverage"] < 0.9 \
            or not np.isfinite(qr["rgb"]).all() or counts["hard_k1"] < 1:
        raise AssertionError("quick_render: no turntable")
    out["quick_render"] = {"coverage": qr["coverage"], "launches": counts}

    for extra in ([], ["--object-pose"]):
        tag = "object_pose_from_depth" + (" --object-pose" if extra else "")
        reset_counts()
        op = object_pose_from_depth.main(["--iters", "200"] + extra)
        counts = read_counts()
        err0, err1 = op["err"]
        print(f"[{tag}] loss {op['losses'][0]:.5f} -> {op['losses'][-1]:.5f}, "
              f"translation error {err0:.4f} -> {err1:.4f} m, "
              f"{op['it_s']:.1f} it/s (set-up and capture included); "
              f"launches (the warm-up iteration and the capture) {counts} "
              f"({card})", flush=True)
        if not (np.isfinite(op["losses"]).all()
                and op["losses"][-1] < op["losses"][0]
                and err1 < 0.6 * err0) or counts["topk_select"] < 1:
            raise AssertionError(f"{tag}: the fit did not converge")
        out[tag] = {"err": [err0, err1], "it_s": op["it_s"],
                    "loss": [float(op["losses"][0]),
                             float(op["losses"][-1])], "launches": counts}
    set_budget_check_default("off")
    return out


# ---------------------------------------------------------------------------
# J. registration, pose search and the finite-difference pose fit
# ---------------------------------------------------------------------------

ICP_ITERS = 100          # the icp_registration app's --icp-iters
FD_IMAGE = 128
FD_STEPS = 100
# svd3 per matrix: 8 sweeps of 3 Jacobi rotations of ~66 operations (three
# 3-dots, the angle's 17, 12 column updates of 3) and ~70 to sort and
# complete u; inputs 36 bytes, outputs 84.
OPS_SVD3 = 8 * 3 * 66 + 70
BYTES_SVD3 = 36 + 84
SVD_TOL = 1e-4           # s, u and vt against the plain Jacobi
ROT_TOL = 1e-5           # the Umeyama rotation against the plain versions'
# u and vt are compared where the singular values lie apart by this share
# of the largest: a singular vector of two nearly equal singular values
# turns with the last bits of its input
SVD_GAP = 1e-2


def _umeyama_rotation(U, Vt):
    from torch_renderer_tpu_torch.ops.cuda_svd3 import det3

    d = torch.sign(det3(U @ Vt))
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)
    return U @ (D[..., None] * Vt)


def svd3_check(cov, card: str) -> dict:
    """svd3 on the ICP's covariances (those its first step hands the
    kernel) against the plain Jacobi on the card (s within SVD_TOL, u and
    vt within SVD_TOL where the singular values lie SVD_GAP apart, the
    Umeyama rotation u D vt within ROT_TOL) and torch.linalg.svd, the
    library call (s within SVD_TOL, the rotation within ROT_TOL); u diag(s)
    vt rebuilds cov within 1e-5 of its largest. Times by events and by
    the profiler."""
    from torch_renderer_tpu_torch.ops import cuda_svd3

    got = cuda_svd3.svd3(cov)
    plain = cuda_svd3.svd3_jacobi(cov)
    lib = torch.linalg.svd(cov)
    torch.cuda.synchronize()
    s = plain[1]
    apart = ((s[:, :2] - s[:, 1:]).amin(-1) > SVD_GAP * s[:, 0])
    vec = max(float((a - b)[apart].abs().max()) if bool(apart.any())
              else 0.0 for a, b in ((got[0], plain[0]), (got[2], plain[2])))
    rot = _umeyama_rotation(got[0], got[2])
    err = max(vec, float((got[1] - s).abs().max()),
              float((rot - _umeyama_rotation(plain[0], plain[2])).abs()
                    .max()))
    rot_lib = float((rot - _umeyama_rotation(lib[0], lib[2])).abs().max())
    s_lib = float((got[1] - lib[1]).abs().max())
    rec_err = float(((got[0] * got[1][..., None, :]) @ got[2] - cov).abs()
                    .max() / cov.abs().max())
    n = cov.shape[0]
    rec = {"shape": list(cov.shape), "max_abs_err": err,
           "apart": int(apart.sum()),
           "rotation_err_vs_library": rot_lib, "s_err_vs_library": s_lib,
           "reconstruction_rel_err": rec_err,
           "ms": time_ms(lambda: cuda_svd3.svd3(cov)),
           "device_ms": device_ms(lambda: cuda_svd3.svd3(cov), "svd3_kernel"),
           "plain_ms": time_ms(lambda: cuda_svd3.svd3_jacobi(cov)),
           "library_ms": time_ms(lambda: torch.linalg.svd(cov)),
           "library_device_ms": device_ms(lambda: torch.linalg.svd(cov),
                                          None),
           **bound(n * BYTES_SVD3, n * OPS_SVD3)}
    print(f"[svd3] {n} covariances of the ICP's first step ({card}): "
          f"{rec}", flush=True)
    if not (err <= SVD_TOL and rot_lib <= ROT_TOL and s_lib <= SVD_TOL
            and rec_err <= 1e-5):
        raise AssertionError("svd3 disagrees with its plain version or "
                             "with torch.linalg.svd")
    return rec


def icp_data(device):
    """TestRegistration's kind of data at the app's scale: 300 objects of
    500 points, the points sampled from the normalized level-3 icosphere
    and made asymmetric as the pose_search app makes its cloud (squashed,
    a lobe on a sixth of them), from one generator seeded 0; the
    registration config's defaults (angle up to 0.3 rad, translation std
    0.05 m)."""
    from torch_renderer_tpu_torch.apps import pose_search
    from torch_renderer_tpu_torch.apps._common import load_scene_mesh
    from torch_renderer_tpu_torch.opt.registration import (
        RegisterDataConfig,
        create_register_data,
    )

    args = pose_search.parse_args([])
    gen = torch.Generator(device=device).manual_seed(0)
    cloud = pose_search.app_cloud(load_scene_mesh(args), 500, gen, True)
    return create_register_data(gen, cloud, RegisterDataConfig())


def icp_phase(device, card: str) -> dict:
    """The icp_registration app at its defaults (300 objects of 500 points
    from the level-3 icosphere, 100 iterations) through main(), counted:
    on a sphere some objects' rotations stay unobserved (the JAX app at
    its defaults on the CPU: mean rotation error 0.022 rad, the port on
    the same data the same within 6e-7; the port's own data: 3-14% of
    objects stuck, by the seed), so its gates are the medians (errors
    below 1e-3 m and 1e-2 rad) and every object converged. Then icp_data eager and captured in turns, each held
    to tests/test_pose_search.py::TestRegistration's gates (means below
    1e-3 m and 1e-2 rad), two objects against the numpy solver, svd3
    against its plain version, replays without a host read, busy share
    and peak memory."""
    from torch_renderer_tpu_torch.apps import icp_registration
    from torch_renderer_tpu_torch.ops import icp
    from torch_renderer_tpu_torch.opt.registration import (
        evaluate_registration,
        icp_cpu_reference,
        register_batch,
    )

    reset_counts()
    app = icp_registration.main([])
    counts = read_counts()
    print(f"[icp app] {app}; launches {counts} ({card})", flush=True)
    # captured: each of the app's two registrations launches svd3 in its
    # eager first step and once more while it is captured
    if counts != only(counts, svd3=4):
        raise AssertionError(f"icp app: launches {counts}")
    med = (float(np.median(app["trans_err"])),
           float(np.median(app["rot_err"])))
    stuck = float((app["rot_err"] > 1e-2).mean())
    print(f"[icp app] median errors {med[0]:.3e} m, {med[1]:.3e} rad; "
          f"share of objects above 1e-2 rad {stuck:.4f}", flush=True)
    if not (med[0] < 1e-3 and med[1] < 1e-2 and app["converged"] == 300):
        raise AssertionError("icp app: registration errors above the gates")
    app = {k: v for k, v in app.items() if k not in ("trans_err", "rot_err")}
    app.update(median_trans_err=med[0], median_rot_err=med[1],
               stuck_share=stuck)

    data = icp_data(device)
    runs = {"eager": [], "captured": []}
    sols = {}
    counted = None
    for k in ("eager", "captured", "captured", "eager"):
        if k == "eager" and counted is None:
            reset_counts()
        (sol, events_s, wall_s), mb = peak_mb(lambda: timed(
            lambda: register_batch(data, ICP_ITERS,
                                   capture=k == "captured")))
        if k == "eager" and counted is None:
            counted = read_counts()
        m = evaluate_registration(sol, data["gt_R"], data["gt_t"])
        r = {"events_s": events_s, "wall_s": wall_s, "peak_mb": mb,
             "mean_trans_err": float(m["mean_trans_err"]),
             "mean_rot_err": float(m["mean_rot_err"]),
             "converged": int(sol.converged.sum())}
        runs[k].append(r)
        sols.setdefault(k, sol)
        print(f"[icp {k}] 300 x 500 points, {ICP_ITERS} iterations: "
              f"{events_s:.4f} s by CUDA events, {wall_s:.4f} s wall; "
              f"{r} ({card})", flush=True)
        if not (r["mean_trans_err"] < 1e-3 and r["mean_rot_err"] < 1e-2):
            raise AssertionError(f"icp {k}: errors above the gates")
    if counted != only(counted, svd3=ICP_ITERS):
        raise AssertionError(f"icp eager: launches {counted}, expected one "
                             "svd3 a step")
    diff = max(float((a - b).abs().max()) for a, b in zip(
        sols["captured"].RTs, sols["eager"].RTs))
    print(f"[icp] captured against eager: max |R, t, s diff| {diff:.3e}",
          flush=True)
    if not diff <= 1e-6:
        raise AssertionError("icp: the captured registration differs from "
                             "the eager one")
    cpu = []
    for b in range(2):
        R, t, _ = icp_cpu_reference(data["source"][b].cpu().numpy(),
                                    data["target"][b].cpu().numpy(),
                                    ICP_ITERS)
        cpu.append(max(float(np.abs(sols["captured"].RTs.R[b].cpu().numpy()
                                    - R).max()),
                       float(np.abs(sols["captured"].RTs.t[b].cpu().numpy()
                                    - t).max())))
    print(f"[icp] objects 0, 1 against the numpy solver: max |diff| {cpu}",
          flush=True)
    if not max(cpu) <= 1e-3:
        raise AssertionError("icp: disagrees with icp_cpu_reference")

    # the kernel on the first step's covariances (recorded by a spy)
    seen = []
    saved = icp.svd3

    def spy(a):
        seen.append(a.clone())
        return saved(a)

    icp.svd3 = spy
    try:
        register_batch(data, 1, capture=False)
    finally:
        icp.svd3 = saved
    kern = svd3_check(seen[0], card)

    with replays_without_sync() as n_rep:
        register_batch(data, ICP_ITERS, capture=True)
    if n_rep[0] != ICP_ITERS - 1:
        raise AssertionError(f"icp: {n_rep[0]} replays")
    prof = {k: _busy_share(lambda: register_batch(
        data, ICP_ITERS, capture=k == "captured"), ICP_ITERS, top=5,
        named=("svd3",)) for k in runs}
    for k, p in prof.items():
        print(f"[icp {k}] profile ({card}): {p}", flush=True)
    return {"app": app, "app_launches": counts, "runs": runs,
            "launches_eager": counted, "captured_vs_eager": diff,
            "cpu_reference_err": cpu, "svd3": kern, "profile": prof}


SEARCH_TARGETS = (([0.3, -0.2, 0.5], [0.1, 0.0, 0.1]),
                  ([0.0, 0.4, -0.6], [0.0, 0.15, -0.05]),
                  ([-0.5, 0.1, 0.2], [-0.1, 0.05, 0.0]))


def search_phase(device, card: str) -> dict:
    """The pose_search app at its defaults (400 hypotheses, elite 100, 10
    iterations, 500 points of its squashed, lobed cloud) through main(),
    counted; its search eager and captured in turns; search_batch on
    tests/test_pose_search.py's three targets and cloud; and the
    chamfer_eval app at its defaults (1000 poses)."""
    from torch_renderer_tpu_torch.apps import chamfer_eval, pose_search
    from torch_renderer_tpu_torch.ops.icosphere import icosphere
    from torch_renderer_tpu_torch.opt.pose_search import (
        GMMPoseSearch,
        PoseSearchConfig,
    )
    from torch_renderer_tpu_torch.transforms.so3 import (
        euler_angles_to_matrix,
        transform_points,
    )

    out = {}
    reset_counts()
    app, mb = peak_mb(lambda: pose_search.main([]))
    counts = read_counts()
    hist = app["best_history"]
    print(f"[pose_search app] best {app['score']:.5f}, pose error "
          f"{app['trans_err']:.4f} m, {math.degrees(app['rot_err']):.2f} "
          f"deg; history {hist.tolist()}; peak {mb:.1f} MiB; launches "
          f"{counts} ({card})", flush=True)
    if not (np.isfinite(hist).all() and (np.diff(hist) <= 0).all()):
        raise AssertionError("pose_search app: the best score rose")
    if counts != only(counts):
        raise AssertionError(f"pose_search app: launches {counts}")
    out["app"] = {"score": app["score"], "trans_err": app["trans_err"],
                  "rot_err": app["rot_err"], "best_history": hist.tolist(),
                  "peak_mb": mb}

    args = pose_search.parse_args([])
    _, ref, _, _, target = pose_search.app_scene(args, device)
    searcher = GMMPoseSearch(ref, PoseSearchConfig())
    runs = {"eager": [], "captured": []}
    res = {}
    for k in ("eager", "captured", "captured", "eager"):
        gen = torch.Generator(device=device).manual_seed(1)
        (o, events_s, wall_s), mb = peak_mb(lambda: timed(
            lambda: searcher.search(gen, target, capture=k == "captured")))
        res.setdefault(k, o)
        runs[k].append({"events_s": events_s, "wall_s": wall_s,
                        "peak_mb": mb, "score": float(o["score"])})
        print(f"[search {k}] 10 iterations x 400 hypotheses: "
              f"{events_s:.4f} s by CUDA events, {wall_s:.4f} s wall, "
              f"best {float(o['score']):.5f}, peak {mb:.1f} MiB ({card})",
              flush=True)
    diff = max(float((res["captured"][n] - res["eager"][n]).abs().max())
               for n in ("pose6d", "score", "best_history"))
    print(f"[search] captured against eager: max |diff| {diff:.3e}",
          flush=True)
    if not diff <= 1e-5:
        raise AssertionError("search: the captured search differs from "
                             "the eager one")
    with replays_without_sync() as n_rep:
        searcher.search(torch.Generator(device=device).manual_seed(1),
                        target, capture=True)
    if n_rep[0] != PoseSearchConfig().n_iters - 1:
        raise AssertionError(f"search: {n_rep[0]} replays")
    prof = {k: _busy_share(lambda: searcher.search(
        torch.Generator(device=device).manual_seed(1), target,
        capture=k == "captured"), PoseSearchConfig().n_iters, top=5)
        for k in runs}
    for k, p in prof.items():
        print(f"[search {k}] profile ({card}): {p}", flush=True)
    out.update(runs=runs, captured_vs_eager=diff, profile=prof)

    # search_batch: tests/test_pose_search.py's cloud, config and targets,
    # the draws from a CPU generator (those of the CPU test)
    verts, _ = icosphere(2)
    cloud = torch.as_tensor(verts * np.array([1.0, 0.6, 0.3], np.float32),
                            device=device)
    cloud[:40] += torch.tensor([0.8, 0.0, 0.0], device=device)
    targets = torch.stack([transform_points(
        euler_angles_to_matrix(torch.tensor(r, device=device), "XYZ"),
        torch.tensor(t, device=device), cloud) for r, t in SEARCH_TARGETS])
    cfg = PoseSearchConfig(n_hypotheses=192, n_elite=48, n_iters=5,
                           translation_std=0.25)
    (ob, events_s, wall_s), mb = peak_mb(lambda: timed(
        lambda: GMMPoseSearch(cloud, cfg).search_batch(
            torch.Generator().manual_seed(0), targets)))
    scores = ob["score"].cpu().numpy()
    print(f"[search_batch] B=3: scores {scores.tolist()} (gate < 0.12), "
          f"{events_s:.4f} s by CUDA events, peak {mb:.1f} MiB ({card})",
          flush=True)
    if not (np.isfinite(scores).all() and (scores < 0.12).all()):
        raise AssertionError("search_batch: a target was not aligned")
    out["batch"] = {"scores": scores.tolist(), "events_s": events_s,
                    "peak_mb": mb}

    reset_counts()
    land, mb = peak_mb(lambda: chamfer_eval.main([]))
    print(f"[chamfer_eval] 1000 poses: corr(chamfer, trans_err) "
          f"{land['corr_trans']:.3f} (gate > 0.3), corr(chamfer, rot_err) "
          f"{land['corr_rot']:.3f}; peak {mb:.1f} MiB; launches "
          f"{read_counts()} ({card})", flush=True)
    if not land["corr_trans"] > 0.3:
        raise AssertionError("chamfer landscape: no correlation")
    out["landscape"] = {"corr_trans": land["corr_trans"],
                        "corr_rot": land["corr_rot"], "peak_mb": mb}
    return out


def fd_setup(device):
    """tests/test_component_parity.py's FD fit at 128^2 on the level-3
    icosphere (1280 faces: the binned raster; budget checks off, as in
    phases C and E): the fitter, meshes, reference depth, start and
    truth."""
    from torch_renderer_tpu_torch.ops.icosphere import icosphere
    from torch_renderer_tpu_torch.opt.pose_fit_fd import (
        FDPoseFitConfig,
        FiniteDifferencePoseFitter,
    )
    from torch_renderer_tpu_torch.structures.meshes import Meshes

    f = 0.9 * FD_IMAGE
    K = np.array([[f, 0, FD_IMAGE / 2], [0, f, FD_IMAGE / 2], [0, 0, 1]],
                 np.float32)
    fitter = FiniteDifferencePoseFitter(
        K, (FD_IMAGE, FD_IMAGE), FDPoseFitConfig(step_size=0.02, eps=2e-3),
        check_budgets="off", device=device)
    meshes = Meshes.from_single(*icosphere(LEVEL), device=device)
    gt = fitter.pack([0.0, 0.0, 0.0], [0.0, 0.0, 3.0], device=device)
    start = fitter.pack([0.05, -0.04, 0.0], [0.08, -0.06, 3.15],
                        device=device)
    return fitter, meshes, fitter.render_depth(meshes, gt), start, gt


def fd_kernel_checks(fitter, meshes, start, card: str) -> dict:
    """hard_k1, gather_tiles_fwd and untile_scatter against their plain
    versions at the FD fit's 12-view call at the start pose, with the
    fit's resolved settings."""
    from torch_renderer_tpu_torch.opt.pose_fit_fd import _fd_rows
    from torch_renderer_tpu_torch.rasterize import cuda_hard
    from torch_renderer_tpu_torch.rasterize.geometry import setup_face_planes

    rows = _fd_rows(start, fitter.config.eps)
    R, t = fitter.unpack(rows)
    st = fitter.renderer.resolved_settings(meshes, R[:1], t[:1])
    fp = setup_face_planes(meshes.extend(rows.shape[0]),
                           fitter.renderer.camera_with_pose(R, t))
    print(f"[fd] the 12-view call's settings: {st}", flush=True)
    with torch.no_grad():
        inp = cuda_hard.binned_inputs(fp, st)
        out = {"hard_k1": hard_k1_check("FD fit", inp, st, card),
               "gather": gather_check("FD fit slab",
                                      *_slab_gather_inputs(inp), card,
                                      bwd=False)}
        del inp
        bins, fields = cuda_hard.binned_tile_fields(fp, st)
        out["untile"], _ = untile_check("FD fit", bins, fields,
                                        (FD_IMAGE, FD_IMAGE), st.bin_size,
                                        card)
    return out


def fd_phase(device, card: str) -> dict:
    """The FD pose fit at 128^2, 100 steps, eager and captured in turns,
    each held to tests/test_component_parity.py's gates; the eager run
    counted (two launches a step of hard_k1, gather_tiles_fwd and
    untile_scatter, nothing else), the captured run's replays profiled
    (the same two a step on the device) and without a host read; the
    three kernels at the fit's 12-view call."""
    fitter, meshes, ref, start, gt = fd_setup(device)
    loss0 = float(fitter.loss(start, meshes, ref))
    err0 = float(torch.linalg.norm(start[3:] - gt[3:]))
    runs = {"eager": [], "captured": []}
    params = {}
    counted = None
    for k in ("eager", "captured", "captured", "eager"):
        if counted is None:
            reset_counts()
        ((p, hist), events_s, wall_s), mb = peak_mb(lambda: timed(
            lambda: fitter.fit(meshes, ref, start, capture=k == "captured")))
        if counted is None:
            counted = read_counts()
        params.setdefault(k, p)
        loss = hist["loss"].cpu().numpy()
        err1 = float(torch.linalg.norm(p[3:] - gt[3:]))
        r = {"steps_s_events": FD_STEPS / events_s,
             "steps_s_wall": FD_STEPS / wall_s, "peak_mb": mb,
             "loss": [loss0, float(loss[-1])], "err": [err0, err1]}
        runs[k].append(r)
        print(f"[fd {k}] {FD_STEPS} steps: {r} ({card})", flush=True)
        if not (np.isfinite(loss).all() and loss[-1] < loss0
                and err1 < err0):
            raise AssertionError(f"fd {k}: the fit did not improve")
    want = only(counted, hard_k1=2 * FD_STEPS,
                gather_tiles_fwd=2 * FD_STEPS, untile_scatter=2 * FD_STEPS)
    print(f"[fd eager] launches {counted}", flush=True)
    if counted != want:
        raise AssertionError(f"fd: launches {counted}, expected {want}")
    diff = float((params["captured"] - params["eager"]).abs().max())
    print(f"[fd] captured params against eager: max |diff| {diff:.3e}",
          flush=True)
    if not diff <= 1e-6:
        raise AssertionError("fd: the captured fit differs from the eager "
                             "one")
    n = PROFILE_ITERS + 2
    with replays_without_sync() as n_rep:
        fitter.fit(meshes, ref, start, n_steps=n, capture=True)
    if n_rep[0] != n - 1:
        raise AssertionError(f"fd: {n_rep[0]} replays of {n} steps")
    kern = full_window(lambda: fitter.fit(meshes, ref, start, n_steps=n,
                                          capture=True),
                       {"hard_k1": 2 * n, "gather_tiles_fwd": 2 * n,
                        "untile_scatter": 2 * n})
    print(f"[fd captured] the port's kernels on the device in a {n}-step "
          f"fit: {kern['ours']}", flush=True)
    if kern["ours"] != only(kern["ours"], hard_k1=2 * n,
                            gather_tiles_fwd=2 * n, untile_scatter=2 * n):
        raise AssertionError("fd captured: not two launches a step")
    prof = {k: _busy_share(lambda: fitter.fit(
        meshes, ref, start, n_steps=n, capture=k == "captured"), n, top=5,
        named=("hard_k1", "gather_fwd", "untile")) for k in runs}
    for k, p in prof.items():
        print(f"[fd {k}] profile of a {n}-step fit ({card}): {p}",
              flush=True)
    checks = fd_kernel_checks(fitter, meshes, start, card)
    return {"runs": runs, "launches_eager": counted, "captured_diff": diff,
            "captured_kernels": kern["ours"], "profile": prof, **checks}


def registration_phase(device, card: str) -> dict:
    """J: ICP registration, the GMM pose search and its landscape, and the
    FD pose fit."""
    return {"icp": icp_phase(device, card),
            "search": search_phase(device, card),
            "fd": fd_phase(device, card)}


# ---------------------------------------------------------------------------
# K. the COCO data generator at 480x640
# ---------------------------------------------------------------------------

COCO_SIZE = (480, 640)
COCO_CHUNK = 8           # DataGenConfig.view_chunk
COCO_TILE = 32           # DataGenConfig.bin_size
COCO_SEED = 0
CANNY_TOL = 1e-4         # of the largest magnitude


@contextlib.contextmanager
def count_coco_calls():
    """Count the generator's chunk renders and visibility renders (each one
    binned K=1 raster)."""
    from torch_renderer_tpu_torch.datagen import coco

    calls = {"chunks": 0, "vis": 0}
    saved = (coco.COCODataGenerator._render_views,
             coco.COCODataGenerator._vis_counts)

    def chunk(self, *a, **k):
        calls["chunks"] += 1
        return saved[0](self, *a, **k)

    def vis(self, *a, **k):
        calls["vis"] += 1
        return saved[1](self, *a, **k)

    coco.COCODataGenerator._render_views = chunk
    coco.COCODataGenerator._vis_counts = vis
    try:
        yield calls
    finally:
        (coco.COCODataGenerator._render_views,
         coco.COCODataGenerator._vis_counts) = saved


def _rle_area(rle) -> int:
    return sum(rle["counts"][1::2])


def coco_app_run(tag: str, argv: list, out_dir: str, card: str) -> dict:
    """One run of the app through main(), counted: every chunk and every
    visibility render run from the host (each eager call, each graph's
    warm-up and capture: "renders_traced") launches hard_k1,
    gather_tiles_fwd and untile_scatter once, a replay none (eager: every
    render is traced; captured: fewer); every annotation clears
    min_visible_px and its RLE covers the image."""
    from torch_renderer_tpu_torch.apps import coco_data_generator as app

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with count_coco_calls() as calls:
        out = app.main(argv + ["--out-dir", out_dir])
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    rasters = calls["chunks"] + calls["vis"]
    traced = out["renders_traced"]
    anns = out["coco"]["annotations"]
    floor = int(argv[argv.index("--min-visible-px") + 1]) \
        if "--min-visible-px" in argv else 0
    H, W = COCO_SIZE
    bad = [a["id"] for a in anns
           if a["area"] < floor or sum(a["segmentation"]["counts"]) != H * W
           or _rle_area(a["segmentation"]) != a["area"]]
    rec = {"images": out["images"], "annotations": len(anns),
           "seconds": out["seconds"], "images_per_s": out["images_per_s"],
           "s_per_scene": out["s_per_scene"], "chunks": calls["chunks"],
           "vis_renders": calls["vis"], "renders_traced": traced,
           "launches": counts, "max_faces_per_bin": out["max_faces_per_bin"],
           "peak_gb": peak, "min_area": min((a["area"] for a in anns),
                                            default=None)}
    print(f"[coco] {tag}: {rec} ({card})", flush=True)
    want = {"hard_k1": traced, "gather_tiles_fwd": traced,
            "untile_scatter": traced}
    for k in counts:
        if k not in want and k != "texsample_fwd" and counts[k]:
            raise AssertionError(f"coco {tag}: unexpected launches {counts}")
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"coco {tag}: expected {want} launches (one a "
                             f"chunk or visibility render run from the "
                             f"host), got {counts}")
    if ("--eager" in argv) != (traced == rasters) or traced > rasters:
        raise AssertionError(f"coco {tag}: {traced} renders run from the "
                             f"host of {rasters}")
    if counts["texsample_fwd"] > min(traced, calls["chunks"]):
        raise AssertionError(f"coco {tag}: texsample_fwd {counts}")
    if bad or not anns or out["images"] == 0:
        raise AssertionError(f"coco {tag}: annotations {bad} fail the "
                             f"min_visible_px {floor} or RLE checks")
    return rec


def _same_outputs(a: str, b: str) -> dict:
    """Two runs' written datasets file for file: the PNGs byte for byte,
    the aux arrays (depth, seg, normals) element for element, the
    annotations and poses equal."""
    files = {d: sorted(os.path.relpath(os.path.join(r, f), d)
                       for r, _, fs in os.walk(d) for f in fs)
             for d in (a, b)}
    differ = []
    for rel in files[a]:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".npy"):
            same = np.array_equal(np.load(pa), np.load(pb))
        elif rel.endswith(".json"):
            with open(pa) as fa, open(pb) as fb:
                same = json.load(fa) == json.load(fb)
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                same = fa.read() == fb.read()
        if not same:
            differ.append(rel)
    return {"files": len(files[a]), "same_names": files[a] == files[b],
            "differ": differ[:10], "n_differ": len(differ),
            "kinds": sorted({os.path.splitext(f)[0].rsplit("_", 1)[-1]
                             for f in files[a] if f.endswith(".npy")})}


def coco_forms(tag: str, argv: list, out_dir: str, card: str) -> dict:
    """The app captured (its default) and eager on the same seed into two
    directories, each counted (coco_app_run), and their written datasets
    compared (_same_outputs): every file equal."""
    import shutil

    runs = {}
    try:
        for form in ("captured", "eager"):
            runs[form] = coco_app_run(
                f"{tag}, {form}", argv + (["--eager"] if form == "eager"
                                          else []),
                os.path.join(out_dir, form), card)
        same = _same_outputs(*(os.path.join(out_dir, f)
                               for f in ("captured", "eager")))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"[coco] {tag}: captured against eager, written files {same} "
          f"({card})", flush=True)
    if same["n_differ"] or not same["same_names"] or not same["files"]:
        raise AssertionError(f"coco {tag}: the captured run's dataset is "
                             f"not the eager run's: {same}")
    return {**runs, "same": same}


def coco_scene(device, capture=False, **kw):
    """A generator (capture: its chunk and visibility renders' form) and
    one sampled scene (COCO_SEED)."""
    from torch_renderer_tpu_torch.datagen import coco

    gen = coco.COCODataGenerator(coco.ObjectLibrary.primitives(),
                                 coco.DataGenConfig(**kw), device=device,
                                 capture=capture)
    rng = np.random.default_rng(COCO_SEED)
    scene, _ = gen.sample_scene(rng)
    return gen, scene, rng


def coco_chunk_inputs(gen, scene, rng):
    """One chunk of a scene as render_scene sees it: the first 8 views
    (bins sized for all of the scene's views), the lights, the batch."""
    from torch_renderer_tpu_torch.shading.lights import PointLights

    n = gen.config.views_per_scene
    Rs, ts = gen._sample_view_poses(rng, n, gen._object_centers(scene))
    gen._ensure_bin_capacity(scene.meshes.extend(n), Rs, ts)
    lights = PointLights.make(location=((0.5, -0.4, 1.8),),
                              device=gen.device)
    R = torch.as_tensor(Rs[:COCO_CHUNK], device=gen.device)
    t = torch.as_tensor(ts[:COCO_CHUNK], device=gen.device)
    return scene.meshes.extend(COCO_CHUNK), R, t, lights


def coco_texture_args(gen, batched, R, t, lights, f2o) -> tuple:
    """The texture sampler's operands in the chunk's shading (one
    TexturesUV.sample call)."""
    from torch_renderer_tpu_torch.structures import textures

    seen, saved = [], textures.sample_bilinear

    def spy(*a):
        seen.append(tuple(x.detach() for x in a))
        return saved(*a)

    textures.sample_bilinear = spy
    try:
        gen._render_chunk(batched, R, t, lights, f2o)
    finally:
        textures.sample_bilinear = saved
    if len(seen) != 1:
        raise AssertionError(f"a textured chunk sampled {len(seen)} times")
    return seen[0]


def canny_check(rgb, card: str) -> dict:
    """canny_edges on the card against the same call on the CPU for one
    chunk's rgb * 255 (low threshold 20, as the generator calls it):
    grad_magnitude within CANNY_TOL of its largest; thresholded's edge
    mask equal, and its values within that tolerance, except at pixels
    where a comparison it makes is within that of its threshold: the
    magnitude against the threshold or against a neighbour, or the
    orientation on a rounding boundary (counted)."""
    from torch_renderer_tpu_torch.ops.canny import canny_edges

    x = rgb * 255.0
    g = canny_edges(x, low_threshold=20.0)
    c = canny_edges(x.cpu(), low_threshold=20.0)
    mag, cmag = g.grad_magnitude.cpu(), c.grad_magnitude
    tol = CANNY_TOL * float(cmag.abs().max())
    err = float((mag - cmag).abs().max())
    p = torch.nn.functional.pad(cmag, (1, 1, 1, 1), value=-1e9)
    H, W = cmag.shape[1:]
    tie = torch.zeros_like(cmag, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                tie |= (cmag - p[:, 1 + dy:1 + dy + H,
                                 1 + dx:1 + dx + W]).abs() <= tol
    # a neighbour tie matters only where the magnitude clears the threshold
    near = ((cmag - 20.0).abs() <= tol) | (tie & (cmag > 20.0 - tol)) \
        | (g.grad_orientation.cpu() != c.grad_orientation)
    thr, cthr = g.thresholded.cpu(), c.thresholded
    diff = (thr > 0) != (cthr > 0)
    far = int((diff & ~near).sum())
    val_err = float(((thr - cthr).abs() * ~near).max())
    rec = {"shape": list(x.shape), "grad_err": err, "tol": tol,
           "thresholded_err": val_err,
           "edge_mask_diff_px": int(diff.sum()),
           "near_threshold_px": int(near.sum()), "diff_outside": far,
           "edge_px": int((c.thresholded > 0).sum()),
           "ms": time_ms(lambda: canny_edges(x, low_threshold=20.0))}
    print(f"[coco] canny on the card vs the CPU, one chunk: {rec} ({card})",
          flush=True)
    if not err <= tol or far or not val_err <= tol:
        raise AssertionError("canny_edges on the card disagrees with the CPU")
    return rec


def settle_check(device, card: str) -> dict:
    """The settle sim captured (replays of a StepGraph) against eager on
    one scene's drop, in the order captured, captured, eager, eager, one
    Settler for each form: R and t within 1e-6, each form's second run
    equal to its first, and no host read inside a replay
    (set_sync_debug_mode "error" during the warm-up and from the first
    replay on) nor anywhere in an eager settle (the same mode throughout)."""
    from torch_renderer_tpu_torch.datagen import coco
    from torch_renderer_tpu_torch.datagen.physics import Settler, drop_poses

    gen = coco.COCODataGenerator(
        coco.ObjectLibrary.primitives(),
        coco.DataGenConfig(placement_mode="physics"), device=device)
    n_max = gen.config.objects_per_scene[1]
    picks = [0, 1, 2, 1, 0]
    pts = np.stack([gen._proxies[j][0] for j in picks])
    radii = np.array([gen._proxies[j][2] for j in picks], np.float32)
    xy = np.array([[0, 0], [0.25, 0.05], [-0.2, 0.2], [0.1, -0.28],
                   [-0.3, -0.2]], np.float32)
    p0, q0 = drop_poses(np.random.default_rng(COCO_SEED), n_max, xy, radii)
    active = np.array([1, 1, 1, 1, 0], np.float32)
    inputs = [torch.as_tensor(a, device=device)
              for a in (pts, radii, p0, q0, active)]
    sims, out, secs = {}, {}, {}
    for form in ("captured", "captured_2", "eager", "eager_2"):
        kind = form.split("_")[0]
        captured = kind == "captured"
        if kind not in sims:
            sims[kind] = Settler(n_max, pts.shape[1], gen._settle_cfg,
                                 device, capture=captured)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (replays_without_sync() if captured
              else host_reads_raise()) as n:
            R, tt, res = sims[kind].settle(*inputs)
        torch.cuda.synchronize()
        secs[form] = time.perf_counter() - t0
        out[form] = (R, tt, float(res), n[0])
    err = max(float((out["captured"][i] - out["eager"][i]).abs().max())
              for i in (0, 1))
    again = max(float((out[f"{f}_2"][i] - out[f][i]).abs().max())
                for f in ("eager", "captured") for i in (0, 1))
    replays = [out[f][3] for f in ("captured", "captured_2")]
    t = out["eager"][1].cpu().numpy()
    rec = {"bodies": n_max, "steps": gen._settle_cfg.sim_steps,
           "steps_per_replay": sims["captured"].unroll,
           "replays": replays, "max_abs_err": err, "repeat_err": again,
           "residual": out["eager"][2], "seconds": secs,
           "min_z": float(t[:4, 2].min())}
    print(f"[coco] settle captured vs eager: {rec} ({card})", flush=True)
    want = gen._settle_cfg.sim_steps // sims["captured"].unroll
    if not err <= 1e-6 or again != 0.0 or not np.isfinite(t).all() \
            or replays != [want - 1, want]:
        raise AssertionError("the captured settle disagrees with eager")
    return rec


def coco_room_chunks(device) -> dict:
    """A textured room scene's first chunk (with edges and the visibility
    check) in a captured and an eager generator of the same seed: {form:
    (generator, (batch, R, t, lights), face_to_object)}."""
    gens = {}
    for form in ("captured", "eager"):
        gen, scene, rng = coco_scene(
            device, capture=form == "captured", material_mode="texture",
            room=True, min_visible_px=200, edge_maps=True)
        gens[form] = (gen, coco_chunk_inputs(gen, scene, rng),
                      scene.face_to_object)
    return gens


def coco_kernel_gates(device, card: str, where: str = "") -> dict:
    """same_kernels for one chunk and one visibility count of a textured
    room scene (coco_room_chunks), a replay against an eager call, one
    call a profiler window; and each form's chunk kernels by name, the
    port's once each. where: a note for the printed tags."""
    gens = coco_room_chunks(device)

    def chunk_of(form):
        gen, (batched_, R_, t_, lights_), f2o_ = gens[form]
        return lambda: gen._render_views(batched_, R_, t_, lights_, f2o_)

    def vis_of(form):
        gen, (batched_, R_, t_, _), f2o_ = gens[form]
        return lambda: gen._vis_counts(batched_, R_, t_, f2o_)

    chunk_of("captured")()        # the first calls: warm-up and capture
    vis_of("captured")()
    raster = {"hard_k1": 1, "gather_tiles_fwd": 1, "untile_scatter": 1}
    want = {**raster, "texsample_fwd": 1}
    out = {"chunk_kernels": same_kernels(
        f"coco chunk{where}",
        lambda c: chunk_of("captured" if c else "eager")(), want)}
    out["vis_kernels"] = same_kernels(
        f"coco visibility count (the chunk's views){where}",
        lambda c: vis_of("captured" if c else "eager")(), raster)
    for form in ("captured", "eager"):
        chunk = full_window(chunk_of(form), want)
        rec = {"ours": chunk["ours"], "kernels": sum(chunk["all"].values()),
               "top": dict(chunk["all"].most_common(8))}
        out["chunk" + ("" if form == "captured" else "_eager")] = rec
        print(f"[coco] one chunk's kernels (8 views, textured room, edges)"
              f"{where}, {form}: {rec} ({card})", flush=True)
        if any(chunk["ours"][k] != v for k, v in want.items()):
            raise AssertionError(f"a {form} chunk's kernels {chunk['ours']}")
    return out


def coco_kernels_in_child(card: str) -> dict:
    """coco_kernel_gates in a process of its own, which has run nothing
    else (phase K runs them in its own process too). Without the markers
    that open kernel_counts' windows, a process that had run the earlier
    phases lost the records of a window's first 18-28 kernels, the same
    aten ops launching them (PERF.md section 7); a fresh process lost
    them rarely."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; "
         "chip_smoke.coco_kernel_gates_main()"],
        cwd=here, capture_output=True, text=True, timeout=600)
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        raise AssertionError("coco kernel gates (child process) failed: "
                             + proc.stderr[-3000:])
    return json.loads(proc.stdout.strip().splitlines()[-1])


def coco_kernel_gates_main() -> None:
    """coco_kernel_gates on cuda:0 with main()'s settings; its record as
    the last line."""
    from torch_renderer_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    _build.load_kernels()
    print(json.dumps(coco_kernel_gates(torch.device("cuda", 0),
                                       card_line()), default=float),
          flush=True)


def coco_phase(device, card: str) -> dict:
    """K: the COCO data generator through the app's main() at its defaults
    (4 scenes x 25 views at 480x640) and at --material-mode texture --room
    --placement physics --edge-maps --min-visible-px 200 (3 scenes), each
    captured and eager, counted, their written datasets equal file for
    file; a scene of each configuration profiled in each form (busy share,
    peak memory); one chunk and one visibility count of a textured room
    scene in each form (a replay's kernels against eager's, in a child
    process, coco_kernels_in_child, and in this one; their device ms); #7,
    #11, #13 and #14 at
    that chunk against their plain versions; the settle sim captured
    against eager; Canny on the card against the CPU."""
    from torch_renderer_tpu_torch.io import native
    from torch_renderer_tpu_torch.rasterize import cuda_hard
    from torch_renderer_tpu_torch.rasterize.binning import (
        set_budget_check_default,
    )
    from torch_renderer_tpu_torch.rasterize.geometry import setup_face_planes
    from torch_renderer_tpu_torch.shading.phong import hard_phong_shader

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "coco_smoke")
    t0 = time.perf_counter()
    lib = native.build()
    print(f"[coco] native library (g++): {lib} in "
          f"{time.perf_counter() - t0:.2f} s (None: the pure-Python "
          "fallbacks run)", flush=True)
    out = {"native": lib is not None}
    # both configurations captured (the default) and eager, every written
    # file compared
    out["defaults_forms"] = coco_forms("app defaults", [], out_dir, card)
    out["textured_forms"] = coco_forms(
        "textured room, physics, edges", [
            "--material-mode", "texture", "--room", "--placement",
            "physics", "--edge-maps", "--min-visible-px", "200",
            "--scenes", "3"], out_dir, card)
    out["defaults"] = out["defaults_forms"]["captured"]
    out["textured"] = out["textured_forms"]["captured"]
    if out["textured"]["launches"]["texsample_fwd"] < 1:
        raise AssertionError("the textured run launched no texsample_fwd")
    set_budget_check_default(None)

    # one scene of each configuration in each form, profiled (the captured
    # generator's graphs made by the first render; the textured room's
    # scene runs the visibility count too)
    named = ("hard_k1_kernel", "gather_fwd_kernel", "untile_kernel",
             "texsample_fwd")
    textured = dict(material_mode="texture", room=True, min_visible_px=200,
                    edge_maps=True, placement_mode="physics")
    for config, kw in (("", {}), ("_textured", textured)):
        for form in ("captured", "eager"):
            gen, scene, rng = coco_scene(device, capture=form == "captured",
                                         **kw)
            gen.render_scene(scene, np.random.default_rng(1))     # warm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            prof = _busy_share(
                lambda: gen.render_scene(scene, np.random.default_rng(1)), 1,
                top=8, named=named)
            prof["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
            out["scene_profile" + config
                + ("" if form == "captured" else "_eager")] = prof
            print(f"[coco] one scene of the {config[1:] or 'defaults'} (25 "
                  f"views), {form}, profiled: {prof} ({card})", flush=True)
            del gen

    # a textured room scene: one chunk and one visibility count in both
    # forms, their kernels gated in a process of their own
    out.update(coco_kernels_in_child(card))
    out["in_process"] = coco_kernel_gates(device, card,
                                          " (in this process)")
    gens = coco_room_chunks(device)

    for form in ("captured", "eager"):
        gen, (batched_, R_, t_, lights_), f2o_ = gens[form]

        def chunk():
            return gen._render_views(batched_, R_, t_, lights_, f2o_)

        def vis():
            return gen._vis_counts(batched_, R_, t_, f2o_)

        chunk()                   # captured: its warm-up and capture
        vis()
        rec = {"device_ms": device_ms(chunk, None, reps=5),
               "ms": time_ms(chunk, reps=5),
               "vis_device_ms": device_ms(vis, None, reps=5),
               "vis_ms": time_ms(vis, reps=5), "max_faces_per_bin": gen._mfb,
               "vis_max_faces_per_bin": gen._vis_mfb}
        out["chunk_times" + ("" if form == "captured" else "_eager")] = rec
        print(f"[coco] one chunk (8 views, textured room, edges), {form}: "
              f"{rec} ({card})", flush=True)
    gens["captured"][0]._chunk_call.release()
    gens["captured"][0]._vis_call.release()
    gen, (batched, R, t, lights), f2o = gens.pop("eager")
    del gens
    st = gen.renderer.settings
    with torch.no_grad():
        fd = setup_face_planes(batched, gen.renderer.camera_with_pose(R, t))
        inp = cuda_hard.binned_inputs(fd, st)
        out["hard_k1"] = hard_k1_check("COCO chunk", inp, st, card,
                                       views=2)
        out["gather"] = gather_check("coco chunk", *_slab_gather_inputs(inp),
                                     card, bwd=False)
        bins, fields = cuda_hard.binned_tile_fields(fd, st)
    out["untile"], _ = untile_check("coco chunk", bins, fields, COCO_SIZE,
                                    COCO_TILE, card)
    del fields, inp
    args = coco_texture_args(gen, batched, R, t, lights, f2o)
    gcot = torch.randn(args[1].shape + (args[0].shape[-1],),
                       generator=torch.Generator(device=device).manual_seed(3),
                       device=device)
    out["tex"] = tex_check("coco chunk", args, gcot, card)
    with torch.no_grad():
        frags, cam = gen.renderer.rasterize(batched, R, t)
        rgb = hard_phong_shader(batched, frags, cam, lights,
                                gen.renderer.materials,
                                gen.renderer.blend)[..., :3]
        out["canny"] = canny_check(rgb, card)
    del frags, rgb
    out["settle"] = settle_check(device, card)
    return out


# ---------------------------------------------------------------------------
# L. the multi-card layer (parallel/): one process per card
# ---------------------------------------------------------------------------

MC_FIT_ITERS = 50        # data_parallel_fit's iterations
# A fit on the card is not repeatable bit for bit: float32 atomics in its
# backward (autograd's scatter-adds, the gather backward kernel) add in an
# order that changes from run to run. Two single-rank fits of 50
# iterations part by 1.6e-4 to 6.5e-4 in their metrics (iou the most); so
# the data-parallel fit's first iteration, which no update has touched yet,
# is held to its single-rank twin within MC_FIT_FIRST_TOL, and its whole
# history within MC_FIT_HISTORY_TOL, about three times that spread.
MC_FIT_FIRST_TOL = 1e-5
MC_FIT_HISTORY_TOL = 2e-3
MC_FIT_BATCH = 4         # its views (one pose each), split over the ranks
MC_SEARCH_TARGETS = 3    # search_batch's targets (uneven over 2 or 4 ranks)
MC_REPS = 10             # timed calls of a sharded path
# make_sharded_pose_step: B views of the level-2 icosphere at 128^2 (the
# streaming coverage sum, as the JAX step), MC_STEPS Adam steps at lr
# MC_STEP_LR in its default form (captured under NCCL) and eagerly. As in
# phase H's fits, float32 atomics in the backward part the two forms'
# gradients in their last bits and Adam turns that into up to a fraction
# of lr on a near-zero component: the first two losses are held within
# 1e-4 and the parameters within MC_STEP_PARAMS_TOL x lr.
MC_STEPS = 6
MC_STEP_BATCH = 2
MC_STEP_IMAGE = 128
MC_STEP_LR = 5e-3
MC_STEP_PARAMS_TOL = 0.25


def multicard_form() -> tuple:
    """(backend, ranks): NCCL with one rank a card over 4 cards (2 where
    there are 2 or 3); two gloo ranks on cuda:0 with one card."""
    from torch_renderer_tpu_torch.parallel.launch import default_backend

    world = 4 if torch.cuda.device_count() >= 4 else 2
    return default_backend(world), world


def _counted(fn):
    """(fn()'s result, the wrapper counts of that call alone)."""
    torch.cuda.synchronize()
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts()


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def mc_silhouette(mesh, device, rank: int) -> dict:
    """The face-sharded soft silhouette at the bench's scale (impl
    "pallas": each rank's face slice through the soft pair and the gather
    pair), alpha and the vertex gradient of its sum; rank 0 also the
    single-rank kernel route on the whole scene."""
    from torch_renderer_tpu_torch import bench
    from torch_renderer_tpu_torch.parallel import soft_silhouette_sharded
    from torch_renderer_tpu_torch.rasterize import cuda_soft
    from torch_renderer_tpu_torch.rasterize.geometry import setup_face_planes

    meshes, cam = bench.scene(B, IMAGE, LEVEL, device)
    with torch.no_grad():
        fpt = cuda_soft.suggest_faces_per_tile(
            setup_face_planes(meshes, cam), cam.image_size, sigma=SIGMA)

    def grad_of(render):
        v = meshes.verts.detach().clone().requires_grad_(True)
        alpha = render(meshes.update_padded(v))
        (g,) = torch.autograd.grad(alpha.sum(), v)
        return alpha.detach(), g

    def sharded():
        return grad_of(lambda m: soft_silhouette_sharded(
            m, cam, mesh, sigma=SIGMA, impl="pallas", faces_per_tile=fpt))

    sharded()
    (alpha, g), counts = _counted(sharded)
    out = {"counts": counts, "faces_per_tile": fpt,
           "ms": time_ms(sharded, MC_REPS)}
    if rank == 0:
        def single():
            return grad_of(lambda m: cuda_soft.soft_silhouette_fd(
                setup_face_planes(m, cam), cam.image_size, sigma=SIGMA,
                faces_per_tile=fpt))

        alpha1, g1 = single()
        out.update(alpha_err=_max_err(alpha, alpha1),
                   grad_err=_max_err(g, g1),
                   grad_max=float(g1.abs().max()),
                   single_ms=time_ms(single, MC_REPS))
    return out


def mc_bench(device) -> dict:
    """One pass of the bench twin's multi-card branch: B views a rank
    (weak scaling), the step captured per rank, no collective in it."""
    from torch_renderer_tpu_torch import bench
    from torch_renderer_tpu_torch.parallel import data_mesh

    meshes, cam, cfg = bench.sharded_scene(B, IMAGE, LEVEL, device,
                                           data_mesh())
    step, _ = bench.make_step(meshes, cam, cfg=cfg)
    (rates, v), counts = _counted(lambda: bench.time_passes(
        step, meshes.verts, B, STEPS, WARMUP, 1))
    return {"img_s": rates[0], "finite": bool(torch.isfinite(v).all()),
            "counts": counts}


def mc_icp(mesh, device, rank: int) -> dict:
    """register_batch_sharded at the app's size (300 objects of 500 points,
    100 iterations; captured per rank); rank 0 also register_batch."""
    from torch_renderer_tpu_torch.opt.registration import (
        register_batch,
        register_batch_sharded,
    )

    data = icp_data(device)

    def sharded():
        return register_batch_sharded(data, mesh, max_iterations=ICP_ITERS)

    sol, counts = _counted(sharded)
    out = {"counts": counts, "ms": time_ms(sharded, 3)}
    if rank == 0:
        plain = register_batch(data, max_iterations=ICP_ITERS)
        out["err"] = max(_max_err(getattr(sol, n), getattr(plain, n))
                         for n in ("rmse", "Xt", "t_history"))
        out["err"] = max(out["err"], *(_max_err(a, b) for a, b in zip(
            sol.RTs, plain.RTs)))
        out["converged"] = int(sol.converged.sum())
    return out


def search_shifts(n: int, device) -> torch.Tensor:
    """(n, 3) translations of search_batch's targets: 0, then steps of
    (0.1, -0.05, 0.05) alternating in sign."""
    k = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    sign = 1.0 - 2.0 * (k % 2)
    return sign * k * torch.tensor([0.1, -0.05, 0.05], device=device)


def mc_search(mesh, device, rank: int) -> dict:
    """search (hypotheses split) and search_batch (MC_SEARCH_TARGETS
    targets split, padded) with device_mesh at the pose_search app's
    defaults (400 hypotheses, elite 100, 10 iterations, its lobed
    500-point cloud); rank 0 also the unsplit calls, and each target of
    the batch searched alone from the batch's draws (G=1: what a rank
    holding one target runs), which must equal the batch's row bit for
    bit."""
    from torch_renderer_tpu_torch.apps import pose_search
    from torch_renderer_tpu_torch.opt.pose_search import (
        GMMPoseSearch,
        PoseSearchConfig,
    )
    from torch_renderer_tpu_torch.transforms.so3 import transform_points

    args = pose_search.parse_args([])
    _, ref, _, _, target = pose_search.app_scene(args, device)
    search = GMMPoseSearch(ref, PoseSearchConfig())
    targets = torch.stack([
        transform_points(torch.eye(3, device=device), s, target)
        for s in search_shifts(MC_SEARCH_TARGETS, device)])

    def calls(mesh_):
        one = search.search(torch.Generator(device=device).manual_seed(7),
                            target, device_mesh=mesh_)
        many = search.search_batch(
            torch.Generator(device=device).manual_seed(11), targets,
            device_mesh=mesh_)
        return one, many

    (one, many), counts = _counted(lambda: calls(mesh))
    out = {"counts": counts, "ms": time_ms(lambda: calls(mesh), 2),
           "score": float(one["score"])}
    if rank == 0:
        p1, pm = calls(None)
        out["err"] = max(_max_err(one[n], p1[n]) for n in (
            "pose6d", "score", "best_history"))
        out["batch_err"] = max(_max_err(many[n], pm[n]) for n in (
            "pose6d", "score", "best_history"))
        draws = search._draws(torch.Generator(device=device).manual_seed(11),
                              MC_SEARCH_TARGETS)
        masks = torch.ones(targets.shape[:2], device=device)
        alone = [search._run_targets(targets, masks, draws, [g], None)
                 for g in range(MC_SEARCH_TARGETS)]
        out["alone_err"] = max(_max_err(a[n][0], pm[n][g])
                               for g, a in enumerate(alone)
                               for n in ("pose6d", "score", "best_history",
                                         "final_elite"))
        out["history_non_increasing"] = bool(
            (one["best_history"][1:] <= one["best_history"][:-1]).all())
    return out


def mc_pose_step(mesh, device) -> dict:
    """make_sharded_pose_step on the face mesh for MC_STEPS steps from a
    shifted start toward the sharded silhouette of the bench's pose: in
    its default form (captured under NCCL, eager under gloo) and with
    capture=False; each step's loss and parameters."""
    import torch.distributed as dist

    from torch_renderer_tpu_torch import bench
    from torch_renderer_tpu_torch.opt.pose_fit import pose_params_from_Rt
    from torch_renderer_tpu_torch.parallel import (
        make_sharded_pose_step,
        soft_silhouette_sharded,
    )

    meshes, cam = bench.scene(MC_STEP_BATCH, MC_STEP_IMAGE, 2, device)
    with torch.no_grad():
        ref = soft_silhouette_sharded(meshes, cam, mesh, sigma=SIGMA)
    R0 = torch.eye(3, device=device).expand(MC_STEP_BATCH, 3, 3)
    t0 = torch.tensor([0.1, -0.05, 3.2], device=device).expand(
        MC_STEP_BATCH, 3)

    def run(capture):
        step = make_sharded_pose_step(mesh, cam, MC_STEP_LR, sigma=SIGMA,
                                      capture=capture)
        params, state = pose_params_from_Rt(R0, t0, device), None
        losses, trail = [], []
        for _ in range(MC_STEPS):
            params, state, loss = step(params, state, meshes, ref)
            losses.append(loss)
            trail.append(params)
        torch.cuda.synchronize()
        return torch.stack(losses), {k: torch.stack([p[k] for p in trail])
                                     for k in params}

    losses, trail = run(None)
    eager, eager_trail = run(False)
    return {"captured": dist.get_backend() == "nccl",
            "losses": [float(x) for x in losses],
            "loss_err": _max_err(losses[:2], eager[:2]),
            "params_err": max(_max_err(trail[k], eager_trail[k])
                              for k in trail)}


def mc_pose_step_one_rank() -> dict:
    """mc_pose_step on a (1, 1) mesh of this rank alone: with one card, a
    world of one NCCL rank, the step captured with the gradients' NCCL
    all_reduce inside (the mesh's axes of size 1 run no collective)."""
    from torch_renderer_tpu_torch.parallel import make_mesh

    return mc_pose_step(make_mesh((1, 1)),
                        torch.device("cuda", torch.cuda.current_device()))


def mc_points(mesh, device, rank: int) -> dict:
    """render_points_sharded at scripts/bench_points.py's scene (4 clouds
    of 20000 points, 256^2, radius 0.01, K=8, bin 16, auto budgets sized
    from every rank's slice); rank 0 also the single-rank render."""
    from torch_renderer_tpu_torch.parallel import render_points_sharded
    from torch_renderer_tpu_torch.renderer import AlphaPointRender

    cloud, K, R, t, _ = points_scene(device)
    sharded_r = AlphaPointRender(K, (POINTS_IMAGE, POINTS_IMAGE),
                                 radius=POINTS_RADIUS, points_per_pixel=8,
                                 device=device)

    def sharded():
        with torch.no_grad():
            return render_points_sharded(sharded_r, cloud, R, t, mesh)

    sharded()
    img, counts = _counted(sharded)
    out = {"counts": counts, "ms": time_ms(sharded, MC_REPS)}
    if rank == 0:
        single_r = AlphaPointRender(K, (POINTS_IMAGE, POINTS_IMAGE),
                                    radius=POINTS_RADIUS,
                                    points_per_pixel=8, device=device)
        with torch.no_grad():
            out["err"] = _max_err(img, single_r.render(cloud, R, t))
        out["coverage"] = float((img.abs().sum(-1) > 0).float().mean())
    return out


def mc_coco(mesh, device, rank: int, out_dir: str) -> dict:
    """The coco_data_generator app with a device mesh at its defaults for
    2 scenes (rank 0 writes; each chunk of 8 views split over the data
    ranks), counted; one scene's packed outputs against the single-rank
    generator's; rank 0 also the app unsplit, annotations equal."""
    from torch_renderer_tpu_torch.apps import coco_data_generator as app
    from torch_renderer_tpu_torch.datagen.coco import (
        COCODataGenerator,
        DataGenConfig,
        ObjectLibrary,
    )

    argv = ["--scenes", "2", "--check-budgets", "off", "--out-dir"]
    res, counts = _counted(lambda: app.run(
        app.parse_args(argv + [os.path.join(out_dir, "sharded")]), mesh))
    out = {"counts": counts, "images": res["images"],
           "images_per_s": res["images_per_s"],
           "annotations": res["annotations"],
           "chunks": 2 * -(-DataGenConfig().views_per_scene // COCO_CHUNK),
           "traced": res["renders_traced"]}

    def one_scene(mesh_):
        gen = COCODataGenerator(ObjectLibrary.primitives(), DataGenConfig(),
                                device_mesh=mesh_, device=device)
        scene, _ = gen.sample_scene(np.random.default_rng(9))
        return gen.render_scene(scene, np.random.default_rng(3))

    split = one_scene(mesh)
    if rank == 0:
        plain = one_scene(None)
        out["differ"] = {k: int((split[k] != plain[k]).sum()) for k in (
            "rgb", "depth", "normals", "segmentation")}
        out["equal"] = not any(out["differ"].values())
        unsplit = app.run(app.parse_args(
            argv + [os.path.join(out_dir, "single")]), None)
        out["annotations_equal"] = \
            unsplit["coco"]["annotations"] == res["coco"]["annotations"]
    return out


def mc_fit(mesh, device, rank: int) -> dict:
    """data_parallel_fit: the pose fit (fragments route, 128^2, auto
    budgets) of MC_FIT_BATCH views of the normalized level-3 icosphere
    around the app's pose, one start each, for MC_FIT_ITERS iterations,
    captured per rank; rank 0 also the single-rank fit of the whole
    batch."""
    from torch_renderer_tpu_torch.cameras.look_at import (
        look_at_view_transform,
    )
    from torch_renderer_tpu_torch.opt.pose_fit import (
        CameraPoseFitter,
        PoseFitConfig,
        pose_params_from_Rt,
    )
    from torch_renderer_tpu_torch.parallel import data_parallel_fit

    meshes, K, _, _, _ = pose_scene(device)
    meshes = meshes.extend(MC_FIT_BATCH)
    azim = torch.linspace(20.0, 110.0, MC_FIT_BATCH)
    R_gt, t_gt = look_at_view_transform(2.7, 15.0, azim)
    rng = np.random.default_rng(0)
    t0 = t_gt.numpy() + 0.1 * rng.standard_normal(
        (MC_FIT_BATCH, 3)).astype(np.float32)

    def fitter():
        return CameraPoseFitter(K, (POSE_IMAGE, POSE_IMAGE),
                                PoseFitConfig(n_steps=MC_FIT_ITERS),
                                device=device, check_budgets="off")

    fs = fitter()
    refs = fs.make_references(meshes, R_gt, t_gt)
    params0 = pose_params_from_Rt(R_gt, t0, device)
    (params, hist), counts = _counted(lambda: data_parallel_fit(
        fs, meshes, refs, params0, mesh, MC_FIT_ITERS))
    out = {"counts": counts, "loss_first": float(hist["loss"][0]),
           "loss_last": float(hist["loss"][-1])}
    if rank == 0:
        # two single-rank fits: float32 atomics in the backward (autograd's
        # scatter-adds, the gather backward kernel) sum in an order that
        # changes from run to run, so the fit on the card is not repeatable
        # bit for bit; the data-parallel fit is held to that spread too
        (p1, h1), (_, h2) = (fitter().fit(meshes, refs, params0,
                                          MC_FIT_ITERS) for _ in range(2))
        out["history_err"] = {k: _max_err(hist[k], h1[k]) for k in h1}
        out["first_err"] = max(_max_err(hist[k][0], h1[k][0]) for k in h1)
        out["params_err"] = max(_max_err(params[k], p1[k]) for k in p1)
        out["single_spread"] = {k: _max_err(h2[k], h1[k]) for k in h1}
    return out


def multicard_rank(backend: str, world: int, out_dir: str) -> dict:
    """Phase L's work on one rank: each sharded path, its wrapper counts
    on this rank, its time by CUDA events, and (rank 0) its comparison
    with the single-rank call."""
    import torch.distributed as dist

    from torch_renderer_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    device = torch.device("cuda", torch.cuda.current_device())
    face = make_mesh((world // 2, 2))        # (1, 2) or (2, 2)
    data = make_mesh((world, 1))
    out = {"rank": rank, "device": str(device),
           "card": torch.cuda.get_device_name(device)}
    t0 = time.perf_counter()
    out["silhouette"] = mc_silhouette(face, device, rank)
    out["bench"] = mc_bench(device)
    out["icp"] = mc_icp(data, device, rank)
    out["search"] = mc_search(data, device, rank)
    out["pose_step"] = mc_pose_step(face, device)
    out["points"] = mc_points(data, device, rank)
    out["coco"] = mc_coco(data, device, rank, out_dir)
    out["fit"] = mc_fit(data, device, rank)
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    return out


def multicard_phase(card: str) -> dict:
    """Phase L: run multicard_rank on every rank, then hold every rank's
    launches and rank 0's comparisons to their gates. Raises on any
    failure."""
    import shutil

    from torch_renderer_tpu_torch.parallel.launch import run_ranks

    backend, world = multicard_form()
    form = (f"nccl, {world} ranks, one card each" if backend == "nccl"
            else f"gloo, {world} ranks on cuda:0")
    print(f"phase L ({card}): {form}", flush=True)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "coco_multicard")
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    ranks = run_ranks(multicard_rank, world, backend, backend, world,
                      out_dir, timeout=900)
    # one card: the captured NCCL form of the pose step on a world of one
    steps = [r["pose_step"] for r in ranks]
    if backend != "nccl":
        steps.append(run_ranks(mc_pose_step_one_rank, 1, "nccl",
                               timeout=300)[0])
        gate_captured = steps[-1]["captured"]
    else:
        gate_captured = all(ps["captured"] for ps in steps)
    seconds = time.perf_counter() - t0
    written = sorted(os.listdir(os.path.join(out_dir, "sharded", "images")))
    shutil.rmtree(out_dir, ignore_errors=True)
    r0 = ranks[0]
    fails = []

    def gate(ok, what):
        if not ok:
            fails.append(what)

    per_call = dict(soft_coverage_fwd=1, soft_coverage_bwd=1,
                    gather_tiles_fwd=1, gather_tiles_bwd=1)
    for r in ranks:
        k = r["rank"]
        gate(r["silhouette"]["counts"] == only(r["silhouette"]["counts"],
                                               **per_call),
             f"rank {k} silhouette launches {r['silhouette']['counts']}")
        gate(r["bench"]["finite"], f"rank {k} bench vertices not finite")
        gate(r["bench"]["counts"]["soft_coverage_fwd"] >= 1,
             f"rank {k} bench launched no soft kernel")
        gate(r["icp"]["counts"]["svd3"] >= 1, f"rank {k} ICP: no svd3")
        pc = r["points"]["counts"]
        gate(pc == only(pc, points_select=1, gather_tiles_fwd=1),
             f"rank {k} points launches {pc}")
        cc, chunks = r["coco"]["counts"], r["coco"]["chunks"]
        traced = r["coco"]["traced"]
        gate(all(cc[n] == traced for n in ("hard_k1", "gather_tiles_fwd",
                                           "untile_scatter"))
             and 1 <= traced <= chunks,
             f"rank {k} coco launches {cc}, {chunks} chunks, {traced} run "
             "from the host (an eager chunk, a graph's warm-up or capture)")
        gate(r["fit"]["counts"]["topk_select"] >= 1,
             f"rank {k} fit launched no topk_select")
    sil = r0["silhouette"]
    gate(sil["alpha_err"] <= 2e-4, f"silhouette alpha err {sil['alpha_err']}")
    gate(sil["grad_err"] <= 1e-3 * sil["grad_max"],
         f"silhouette grad err {sil['grad_err']} of {sil['grad_max']}")
    gate(r0["icp"]["err"] <= 1e-5, f"ICP err {r0['icp']['err']}")
    gate(r0["search"]["err"] <= 1e-5 and r0["search"]["batch_err"] <= 1e-5,
         f"search err {r0['search']['err']} / {r0['search']['batch_err']}")
    gate(r0["search"]["history_non_increasing"], "search history rose")
    gate(r0["search"]["alone_err"] == 0.0,
         f"a target searched alone differs from its row of the batch by "
         f"{r0['search']['alone_err']}")
    gate(gate_captured, "the pose step was not captured under NCCL")
    for k, ps in enumerate(steps):
        gate(ps["loss_err"] <= 1e-4 and ps["params_err"]
             <= MC_STEP_PARAMS_TOL * MC_STEP_LR,
             f"pose step {k} (captured {ps['captured']}) vs eager: loss "
             f"err {ps['loss_err']}, params err {ps['params_err']}")
        gate(ps["losses"][-1] < ps["losses"][0],
             f"pose step {k} loss did not fall: {ps['losses']}")
    gate(r0["points"]["err"] <= 1e-5, f"points err {r0['points']['err']}")
    gate(r0["coco"]["equal"], "coco outputs differ from the single rank's: "
         f"{r0['coco']['differ']} elements")
    gate(r0["coco"]["annotations_equal"], "coco annotations differ")
    gate(len(written) == r0["coco"]["images"], f"coco wrote {len(written)}")
    fe, fs = r0["fit"]["history_err"], r0["fit"]["single_spread"]
    gate(r0["fit"]["first_err"] <= MC_FIT_FIRST_TOL,
         f"fit's first iteration err {r0['fit']['first_err']}")
    gate(all(v <= MC_FIT_HISTORY_TOL for v in fe.values()),
         f"fit history err {fe} (two single-rank fits: {fs})")
    gate(r0["fit"]["loss_last"] < r0["fit"]["loss_first"],
         "fit loss did not fall")
    print(f"phase L ({card}; {form}; two ranks on one card are a "
          "correctness run, not scaling): "
          f"sharded silhouette fwd+bwd {sil['ms']:.3f} ms a call (single "
          f"rank {sil['single_ms']:.3f}); bench twin "
          + ", ".join(f"{r['bench']['img_s']:.1f}" for r in ranks)
          + f" img/s per card over {world}; ICP {r0['icp']['ms']:.2f} ms; "
          f"search {r0['search']['ms']:.1f} ms (a target alone against "
          f"its row of the batch: {r0['search']['alone_err']}); pose step "
          + "; ".join(f"{'captured' if ps['captured'] else 'eager'} "
                      f"{ps['params_err']:.3g}" for ps in steps)
          + " from eager in params"
          + (" (the last on one NCCL rank); " if backend != "nccl" else "; ")
          + "points "
          f"{r0['points']['ms']:.3f} ms; coco {r0['coco']['images_per_s']:.1f}"
          f" images/s; {seconds:.1f} s in all", flush=True)
    if fails:
        raise RuntimeError("phase L failed: " + "; ".join(fails))
    return {"form": form, "backend": backend, "ranks": world,
            "seconds": seconds, "per_rank": ranks, "pose_steps": steps}


# ---------------------------------------------------------------------------
# M. wide bins: tiles past one kernel block, K past the shared-memory lists
# ---------------------------------------------------------------------------

WIDE_TILE = 64
WIDE_TILES = (48, 64)         # hard_k1's wide tiles
WIDE_K = 128                  # topk_select at tile 16, past the old 64
DEVICE_LIST_K = 1000          # topk_select with its lists in device memory
WIDE_POINTS_K = 65            # points_select at tile 16, past the old 64
WIDE_POINTS_TILE_K = 8        # points_select at tile 64
RAY_TOL = 2e-3                # depth against the ray caster (phase I's)
ALPHA_TOL = 2e-4              # alpha against the dense oracle (phase A's)


# each kernel check of phase M (wide_checks) and the cases of its counted
# main path (wide_main_path) that launched that kernel at that shape
WIDE_ROWS = {
    "hard_k1_tile48": (("raster tile 48 K=1", "hard_k1"),),
    "hard_k1_tile64": (("raster tile 64 K=1", "hard_k1"),
                       ("pose app pallas", "hard_k1")),
    "hard_k1_tile64_depth_call": (("depth app", "hard_k1"),
                                  ("depth app captured", "hard_k1"),
                                  ("depth call vs ray caster", "hard_k1")),
    "topk_select_tile64_k4": (("raster tile 64 K=4", "topk_select"),
                              ("pose app fragments", "topk_select")),
    "topk_select_tile16_k128": (("raster tile 16 K=128", "topk_select"),),
    "topk_select_tile16_k1000": (("raster tile 16 K=1000", "topk_select"),),
    "points_select_tile64_k8": (("points tile 64 K=8", "points_select"),),
    "points_select_tile16_k65": (("points tile 16 K=65", "points_select"),),
    "soft_tile64 fwd": (("soft tile 64", "soft_coverage_fwd"),),
    "soft_tile64 bwd": (("soft tile 64", "soft_coverage_bwd"),),
}


@contextlib.contextmanager
def launches_into(cases: dict, case: str):
    """cases[case]: the launches the wrappers counted inside the block, by
    kernel (the kernels that launched only)."""
    before = read_counts()
    yield
    after = read_counts()
    cases[case] = {k: after[k] - before[k] for k in after
                   if after[k] != before[k]}


def row_launches(cases: dict, row: str) -> int:
    """A phase M check's launches on the counted main path (WIDE_ROWS)."""
    return sum(cases.get(case, {}).get(kern, 0)
               for case, kern in WIDE_ROWS[row])


def raycast_depth(verts, faces, K, R, t, size, chunk: int = 4096):
    """Float64 ray-cast depth (B, H, W) of one mesh (verts (V, 3), faces
    (F, 3)) under B poses, on the card: baselines.raytrace_depth's Moller-
    Trumbore, pixel rays from the camera origin through pixel centres,
    depth the ray parameter (camera z), 0 where no face is hit."""
    H, W = size
    dev = verts.device
    f64 = torch.float64
    Kd = torch.as_tensor(np.asarray(K), dtype=f64, device=dev)
    ii, jj = torch.meshgrid(torch.arange(H, dtype=f64, device=dev),
                            torch.arange(W, dtype=f64, device=dev),
                            indexing="ij")
    d = torch.stack([(jj.reshape(-1) + 0.5 - Kd[0, 2]) / Kd[0, 0],
                     (ii.reshape(-1) + 0.5 - Kd[1, 2]) / Kd[1, 1],
                     torch.ones(H * W, dtype=f64, device=dev)], dim=-1)
    out = []
    for b in range(R.shape[0]):
        tri = (verts.to(f64) @ R[b].to(f64).T + t[b].to(f64))[faces]
        v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
        q = torch.cross(-v0, e1, dim=-1)                       # (F, 3)
        depth = torch.empty(H * W, dtype=f64, device=dev)
        for lo in range(0, H * W, chunk):
            dc = d[lo:lo + chunk]                              # (p, 3)
            h = torch.cross(dc[:, None, :].expand(-1, e2.shape[0], -1),
                            e2[None].expand(dc.shape[0], -1, -1), dim=-1)
            a = (e1[None] * h).sum(-1)
            inv = torch.where(a.abs() < 1e-14, torch.zeros_like(a), 1.0 / a)
            uu = inv * (-v0[None] * h).sum(-1)
            vv = inv * (dc @ q.T)
            tt = inv * (e2 * q).sum(-1)[None]
            hit = (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & (tt > 1e-5) \
                & (a.abs() >= 1e-14)
            best = torch.where(hit, tt, torch.full_like(tt, math.inf)).amin(1)
            depth[lo:lo + chunk] = torch.where(torch.isfinite(best), best,
                                               torch.zeros_like(best))
        out.append(depth.reshape(H, W))
    return torch.stack(out)


def wide_main_path(device, card: str) -> dict:
    """M's counted run: the widened kernels through the port's entry
    points at the new shapes, and the depth and pose apps at --bin-size 64
    at full size. Returns the launches by wrapper, the launches of each
    case (launches_into), the depth app's budgets and each path's gates."""
    import io

    import torch_renderer_tpu_torch as trt
    from torch_renderer_tpu_torch import bench
    from torch_renderer_tpu_torch.apps import (
        batch_render_bench,
        camera_pose_optimizer,
        render_compare,
    )
    from torch_renderer_tpu_torch.rasterize import autotune
    from torch_renderer_tpu_torch.rasterize.binning import (
        set_budget_check_default,
    )
    from torch_renderer_tpu_torch.rasterize.points import (
        PointsRasterizationSettings,
        suggest_points_per_bin,
    )

    set_budget_check_default("off")
    out, cases = {}, {}
    smeshes, scam = bench.scene(B, IMAGE, LEVEL, device)
    pmeshes, Kp, R_gt, t_gt, _ = pose_scene(device)
    pcam = trt.PerspectiveCamera.from_K(Kp, (POSE_IMAGE, POSE_IMAGE),
                                        R=R_gt, t=t_gt, device=device)
    cloud, Kc, Rc, tc, _ = points_scene(device)
    ccam = trt.AlphaPointRender(Kc, (POINTS_IMAGE, POINTS_IMAGE),
                                device=device).camera_with_pose(Rc, tc)
    point_st = {}
    for tile, Kq in ((WIDE_TILE, WIDE_POINTS_TILE_K), (16, WIDE_POINTS_K)):
        probe = PointsRasterizationSettings(
            (POINTS_IMAGE, POINTS_IMAGE), radius=POINTS_RADIUS,
            points_per_pixel=Kq, bin_size=tile)
        point_st[tile, Kq] = dataclasses.replace(
            probe, max_points_per_bin=suggest_points_per_bin(cloud, ccam,
                                                             probe))
    dense = trt.soft_silhouette_streaming(smeshes, scam, sigma=SIGMA,
                                          pixel_chunk=4096)
    torch.cuda.synchronize()

    reset_counts()
    # the soft pair at tile 64 through the public entry, bench scene, a
    # face budget of the whole mesh (no tile drops a face)
    with launches_into(cases, f"soft tile {WIDE_TILE}"):
        v = smeshes.verts.clone().requires_grad_(True)
        alpha = trt.soft_silhouette(
            smeshes.update_padded(v), scam, sigma=SIGMA, tile=WIDE_TILE,
            faces_per_tile=int(smeshes.num_faces.max()), impl="pallas")
        (g,) = torch.autograd.grad(alpha.sum(), v)
    a_err = float((alpha.detach() - dense).abs().max())
    print(f"[wide] soft_silhouette(tile={WIDE_TILE}, impl='pallas') at the "
          f"bench scene: max|alpha - dense oracle| {a_err:.3e} (tol "
          f"{ALPHA_TOL}), gradient finite {bool(torch.isfinite(g).all())}",
          flush=True)
    if not a_err <= ALPHA_TOL or not bool(torch.isfinite(g).all()):
        raise AssertionError("wide bins: the tile-64 soft silhouette")
    out["soft"] = {"alpha_err": a_err}
    # the mesh raster at the pose scene, each with the gradient of its
    # depth: hard_k1 at tiles 48 and 64, topk_select at tile 64 K=4, at
    # tile 16 K=128 and at K=1000 (lists in device memory)
    F = int(pmeshes.num_faces.max())
    frags = {}
    for tile, Kf, blur in [(t_, 1, 0.0) for t_ in WIDE_TILES] + [
            (WIDE_TILE, 4, POSE_BLUR), (16, WIDE_K, POSE_BLUR),
            (16, DEVICE_LIST_K, POSE_BLUR)]:
        st = trt.RasterizationSettings(
            (POSE_IMAGE, POSE_IMAGE), blur_radius=blur, faces_per_pixel=Kf,
            bin_size=tile, max_faces_per_bin=int(F), check_budgets="off")
        with launches_into(cases, f"raster tile {tile} K={Kf}"):
            vp = pmeshes.verts.clone().requires_grad_(True)
            fr = trt.rasterize_meshes(pmeshes.update_padded(vp), pcam, st)
            (gp,) = torch.autograd.grad((fr.zbuf * fr.mask).sum(), vp)
        frags[tile, Kf] = fr.pix_to_face.detach()
        if not bool(torch.isfinite(gp).all()):
            raise AssertionError(f"wide bins: raster tile {tile} K={Kf}")
    # the same faces as at tile 16 (K=1, no ties there) and K=1000's
    # first 128 slots as K=128's
    with torch.no_grad():
        base = trt.rasterize_meshes(
            pmeshes, pcam, trt.RasterizationSettings(
                (POSE_IMAGE, POSE_IMAGE), bin_size=16,
                max_faces_per_bin=int(F), check_budgets="off")).pix_to_face
    for t_ in WIDE_TILES:
        if not torch.equal(frags[t_, 1], base):
            raise AssertionError(f"wide bins: K=1 at tile {t_} selects "
                                 "other faces than at tile 16")
    if not torch.equal(frags[16, DEVICE_LIST_K][..., :WIDE_K],
                       frags[16, WIDE_K]):
        raise AssertionError("wide bins: K=1000's first 128 winners are "
                             "not K=128's")
    out["raster_live_max"] = {f"{t_}_{k}": int((fr >= 0).sum(-1).max())
                              for (t_, k), fr in frags.items()}
    # the point raster at tile 64 K=8 and tile 16 K=65
    for (tile, Kq), st in point_st.items():
        with launches_into(cases, f"points tile {tile} K={Kq}"), \
                torch.no_grad():
            pf = trt.rasterize_points(cloud, ccam, st)
        if int((pf.idx[..., 0] >= 0).sum()) < 1000:
            raise AssertionError(f"wide bins: points tile {tile} K={Kq}")
    # the depth app at --bin-size 64 at its defaults (120 views of 1280x720
    # in calls of 12), eager (every call launches its kernels) and captured
    # (the default: each call run from the host launches them once, the
    # graphs' warm-ups and captures, "traced"; a capture fails on a host
    # read), its 120 views bit for bit the eager run's
    with launches_into(cases, "depth app"):
        app = batch_render_bench.main(["--cards", "1", "--bin-size",
                                       str(WIDE_TILE), "--eager"])
    with launches_into(cases, "depth app captured"):
        app_c = batch_render_bench.main(["--cards", "1", "--bin-size",
                                         str(WIDE_TILE)])
    differ = int((app.pop("views") != app_c.pop("views")).sum())
    calls, app_counts = app["calls"], cases["depth app"]
    traced, counts_c = app_c["traced"], cases["depth app captured"]
    print(f"[wide] depth app --bin-size {WIDE_TILE} captured: {calls} "
          f"calls, {traced} run from the host, launches {counts_c}, "
          f"{app_c['images_per_s']:.1f} images/s batched, "
          f"{app_c['serial_images_per_s']:.1f} serial; against eager "
          f"({app['images_per_s']:.1f} / {app['serial_images_per_s']:.1f}): "
          f"{differ} pixels of the {BATCH_VIEWS} views differ ({card})",
          flush=True)
    if app_counts != {"hard_k1": calls, "gather_tiles_fwd": calls,
                      "untile_scatter": calls}:
        raise AssertionError(f"depth app --bin-size {WIDE_TILE}: "
                             f"launches {app_counts}")
    if not 0 < traced < app_c["calls"] or counts_c != {
            "hard_k1": traced, "gather_tiles_fwd": traced,
            "untile_scatter": traced}:
        raise AssertionError(f"depth app --bin-size {WIDE_TILE} captured: "
                             f"{traced} calls run from the host of "
                             f"{app_c['calls']}, launches {counts_c}")
    if differ:
        raise AssertionError(f"depth app --bin-size {WIDE_TILE}: the "
                             "captured views are not the eager views bit "
                             "for bit")
    budgets = {k: app[k] for k in ("max_faces_per_bin", "active_tiles",
                                   "occupancy_split")}
    batched, Rb, tb, Kb, kw = _batch_chunk(device, budgets, WIDE_TILE)
    with launches_into(cases, "depth call vs ray caster"), torch.no_grad():
        depth = trt.DepthRender(Kb, BATCH_SIZE, **kw).render(batched, Rb, tb)
    with torch.no_grad():
        mesh0 = batched.verts[0], batched.faces[0].long()
        ray = raycast_depth(*mesh0, Kb, Rb, tb, BATCH_SIZE)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        worst = render_compare._diff_report(
            "depth app bin 64 vs ray caster", depth.cpu().numpy(),
            ray.cpu().numpy())
    print(f"[wide] depth app --bin-size {WIDE_TILE}: {calls} calls, "
          f"{app['images_per_s']:.1f} images/s batched; budgets "
          f"{app['max_faces_per_bin']} / {app['active_tiles']} / "
          f"{app['occupancy_split']}; one call's 12 views against the "
          f"float64 ray caster: worst interior |diff| {worst:.6f} (tol "
          f"{RAY_TOL}); launches {app_counts} ({card})", flush=True)
    if not worst < RAY_TOL:
        raise AssertionError("depth app at bin 64: depth is not within "
                             "2e-3 of the ray caster")
    out["depth_app"] = {"worst": float(worst), "calls": calls,
                        "images_per_s": app["images_per_s"],
                        "captured": {k: app_c[k] for k in (
                            "images_per_s", "serial_images_per_s",
                            "traced")},
                        "captured_differ": differ, "budgets": budgets}
    # the pose app at --bin-size 64 on both routes at its defaults (face
    # budget: the whole mesh, so no tile drops a face)
    out["pose_app"] = {}
    for route in ("fragments", "pallas"):
        autotune.clear_cache()
        with launches_into(cases, f"pose app {route}"):
            losses, ious, err0, err1 = camera_pose_optimizer.main(
                ["--bin-size", str(WIDE_TILE), "--max-faces-per-bin",
                 str(int(F)), "--silhouette-impl", route])
        counts = cases[f"pose app {route}"]
        print(f"[wide] pose app --bin-size {WIDE_TILE} {route}: loss "
              f"{losses[0]:.5f} -> {losses[-1]:.5f}, iou {ious[0]:.3f} -> "
              f"{ious[-1]:.3f}, translation error {err0:.4f} -> {err1:.4f} "
              f"m; launches {counts} ({card})", flush=True)
        need = ("topk_select",) if route == "fragments" else (
            "hard_k1", "soft_coverage_fwd", "soft_coverage_bwd")
        if not (np.isfinite(losses).all()
                and losses[-1] < 0.1 * losses[0] and err1 < 0.1 * err0
                and min(counts.get(k, 0) for k in need) >= 1):
            raise AssertionError(f"pose app --bin-size {WIDE_TILE} {route}: "
                                 "the fit failed its gates")
        out["pose_app"][route] = {"loss": [float(losses[0]),
                                           float(losses[-1])],
                                  "err": [err0, err1]}
    counts = read_counts()
    print(f"[wide] main path launches {counts}; by case {cases} ({card})",
          flush=True)
    missing = sorted({(c, k) for row in WIDE_ROWS.values() for c, k in row
                      if cases.get(c, {}).get(k, 0) < 1})
    if missing:
        raise AssertionError(f"wide bins: no launch in {missing}")
    autotune.clear_cache()
    return {"counts": counts, "cases": cases, **out}


def wide_checks(device, card: str, budgets: dict) -> dict:
    """M's kernel checks: each widened kernel against its plain version at
    the new shapes (hard_k1 bit for bit, winners identical, the soft pair
    within phase A's bounds), with its times and bound; hard_k1 at tile 64
    also on one call of the depth app at --bin-size 64 (budgets: the ones
    the app sized, wide_main_path)."""
    import torch_renderer_tpu_torch as trt
    from torch_renderer_tpu_torch import bench
    from torch_renderer_tpu_torch.rasterize import (
        cuda_hard,
        cuda_points,
        cuda_soft,
    )
    from torch_renderer_tpu_torch.rasterize.binning import (
        bin_faces_active,
        tile_grid,
    )
    from torch_renderer_tpu_torch.rasterize.points import (
        PointsRasterizationSettings,
        project_points_screen,
        suggest_points_per_bin,
    )
    from torch_renderer_tpu_torch.rasterize.soft import SOFT_CUTOFF

    out = {}
    meshes, Kp, R_gt, t_gt, _ = pose_scene(device)
    cam = trt.PerspectiveCamera.from_K(Kp, (POSE_IMAGE, POSE_IMAGE), R=R_gt,
                                       t=t_gt, device=device)
    fp = trt.setup_face_planes(meshes, cam)
    for tile in WIDE_TILES:
        st = trt.RasterizationSettings(
            (POSE_IMAGE, POSE_IMAGE), bin_size=tile,
            max_faces_per_bin=fp.num_faces, check_budgets="off")
        out[f"hard_k1_tile{tile}"] = hard_k1_check(
            f"tile {tile}", cuda_hard.binned_inputs(fp, st), st, card)
    batched, Rb, tb, Kb, kw = _batch_chunk(device, budgets, WIDE_TILE)
    rp = trt.DepthRender(Kb, BATCH_SIZE, **kw)
    with torch.no_grad():
        inp = cuda_hard.binned_inputs(trt.setup_face_planes(
            batched, rp.camera_with_pose(Rb, tb)), rp.settings)
        out[f"hard_k1_tile{WIDE_TILE}_depth_call"] = hard_k1_check(
            f"tile {WIDE_TILE}, 720p depth call", inp, rp.settings, card,
            views=2)
    del inp
    for tile, Kf in ((WIDE_TILE, 4), (16, WIDE_K), (16, DEVICE_LIST_K)):
        st = trt.RasterizationSettings(
            (POSE_IMAGE, POSE_IMAGE), blur_radius=POSE_BLUR,
            faces_per_pixel=Kf, bin_size=tile,
            max_faces_per_bin=fp.num_faces, check_budgets="off")
        rec = topk_check(f"tile {tile} K={Kf}",
                         cuda_hard.binned_inputs(fp, st), st, exact=True)
        rec["device_lists"] = bool(_build_lib().trt_topk_device_lists(Kf))
        out[f"topk_select_tile{tile}_k{Kf}"] = rec
    # points_select at the point bench scene
    cloud, Kc, Rc, tc, _ = points_scene(device)
    ccam = trt.AlphaPointRender(Kc, (POINTS_IMAGE, POINTS_IMAGE),
                                device=device).camera_with_pose(Rc, tc)
    for tile, Kq in ((WIDE_TILE, WIDE_POINTS_TILE_K), (16, WIDE_POINTS_K)):
        st = PointsRasterizationSettings(
            (POINTS_IMAGE, POINTS_IMAGE), radius=POINTS_RADIUS,
            points_per_pixel=Kq, bin_size=tile)
        st = dataclasses.replace(st, max_points_per_bin=suggest_points_per_bin(
            cloud, ccam, st))
        with torch.no_grad():
            q, z, valid = project_points_screen(cloud, ccam, st.znear)
            r2 = POINTS_RADIUS * POINTS_RADIUS
            inp = cuda_points.binned_point_inputs(
                q, z, valid, torch.full_like(z, r2), st, uniform_r2=r2)
        out[f"points_select_tile{tile}_k{Kq}"] = points_select_check(
            f"tile {tile} K={Kq}", inp, st, card)
    # the soft pair at tile 64 on the bench scene's slab (every tile
    # active, as many slots as the fullest tile's candidates: none drops)
    smeshes, scam = bench.scene(B, IMAGE, LEVEL, device)
    sfp = trt.setup_face_planes(smeshes, scam)
    TH, TW, _ = tile_grid((IMAGE, IMAGE), WIDE_TILE)
    bins = bin_faces_active(sfp, (IMAGE, IMAGE), WIDE_TILE,
                            math.sqrt(SOFT_CUTOFF * SIGMA), TH * TW)
    q, count = cuda_soft.tile_slabs(sfp, bins, int(bins.count.max()))
    out[f"soft_tile{WIDE_TILE}"] = soft_pair_check(
        f"tile {WIDE_TILE} bench slab", q.detach(), count, WIDE_TILE,
        1.0 / (IMAGE / 2.0), 1.0 / SIGMA, card)
    return out


def _build_lib():
    from torch_renderer_tpu_torch import _build

    return _build.load_kernels()


def old_shape_times(device, card: str) -> dict:
    """The widened kernels at PERF.md section 6's existing shapes, events
    ms and alone ms, to hold this tree's plans and times against its
    parent's in one call: the soft pair at the bench slab and the pose
    fit's pallas slab; hard_k1 at the pose slab, one 720p depth call (tile
    32), the FD fit's 12-view call and a textured-room COCO chunk;
    topk_select at the pose fit's K=4, at K=50 and at the joint fit's K=8
    (its source mesh: the slab the fit's budgets give, before any step);
    points_select at the point bench slab (uniform r^2) and the Pulsar
    sphere slab (per-point r^2). Reaches the kernels through the public
    wrappers only, so it runs on a parent tree too."""
    import torch_renderer_tpu_torch as trt
    from torch_renderer_tpu_torch import bench
    from torch_renderer_tpu_torch.apps._common import pinhole_K
    from torch_renderer_tpu_torch.rasterize import (
        autotune,
        cuda_hard,
        cuda_points,
        cuda_soft,
    )
    from torch_renderer_tpu_torch.rasterize.binning import (
        bin_faces_active,
        count_overflow,
        set_budget_check_default,
        suggest_active_tiles_fd,
        suggest_occupancy_split_fd,
        tile_grid,
    )
    from torch_renderer_tpu_torch.rasterize.points import (
        project_points_screen,
    )
    from torch_renderer_tpu_torch.rasterize.soft import SOFT_CUTOFF

    set_budget_check_default("off")
    out = {}

    def times(name, fn, kernel):
        out[name] = {"ms": time_ms(fn), "device_ms": device_ms(fn, kernel)}

    # the soft pair: the bench slab (packed config) and the pose slab
    meshes, cam = bench.scene(B, IMAGE, LEVEL, device)
    fp0 = trt.setup_face_planes(meshes, cam)
    cfg = trt.suggest_soft_config(fp0, (IMAGE, IMAGE), sigma=SIGMA,
                                  layout="packed")
    pad = math.sqrt(SOFT_CUTOFF * SIGMA)
    bins = bin_faces_active(fp0, (IMAGE, IMAGE), cfg.tile, pad,
                            cfg.active_tiles)
    q, count = cuda_soft.tile_slabs(fp0, bins,
                                    min(cfg.faces_per_tile, fp0.num_faces))
    pmeshes, Kp, R_gt, t_gt, _ = pose_scene(device)
    pcam = trt.PerspectiveCamera.from_K(Kp, (POSE_IMAGE, POSE_IMAGE),
                                        R=R_gt, t=t_gt, device=device)
    pfp = trt.setup_face_planes(pmeshes, pcam)
    TH, TW, _ = tile_grid((POSE_IMAGE, POSE_IMAGE), 16)
    pbins = bin_faces_active(pfp, (POSE_IMAGE, POSE_IMAGE), 16, pad, TH * TW)
    pq, pcount = cuda_soft.tile_slabs(pfp, pbins, min(128, pfp.num_faces))
    for tag, qq, cc, inv_s in (
            ("bench", q.detach(), count, 1.0 / (IMAGE / 2.0)),
            ("pose", pq.detach(), pcount, 1.0 / (POSE_IMAGE / 2.0))):
        g = torch.rand(cc.shape + (cfg.tile * cfg.tile,), device=device)
        times(f"soft_fwd_{tag}", lambda: cuda_soft.soft_coverage_fwd(
            qq, cc, 16, inv_s, 1.0 / SIGMA), "soft_coverage_fwd_kernel")
        times(f"soft_bwd_{tag}", lambda: cuda_soft.soft_coverage_bwd(
            qq, cc, g, 16, inv_s, 1.0 / SIGMA), "soft_coverage_bwd_kernel")
    # the hard kernels at the pose fit's slabs
    for Kf, blur in ((1, 0.0), (4, POSE_BLUR), (50, 1e-4)):
        st, inp = _kernel_inputs(pmeshes, pcam, Kf, blur)
        if Kf == 1:
            args = (inp.slab, inp.count, inp.origin, st.bin_size, inp.inv_s,
                    0.0, st.znear, st.clip_bary)
            times("hard_k1_pose", lambda: cuda_hard.hard_k1(*args),
                  "hard_k1_kernel")
        else:
            args = (inp.slab, inp.count, inp.origin, Kf, st.bin_size,
                    inp.inv_s, blur, st.znear)
            times(f"topk_select_pose_k{Kf}",
                  lambda: cuda_hard.topk_select(*args), "topk_select")
    autotune.clear_cache()
    # hard_k1 at one 720p depth call, budgets as the app sizes them
    H, W = BATCH_SIZE
    azims = np.linspace(0.0, 360.0, BATCH_VIEWS, endpoint=False)
    R_all, t_all = trt.look_at_view_transform(
        2.7, 15.0, torch.from_numpy(azims.astype(np.float32)))
    bm = trt.Meshes.from_single(*trt.icosphere(LEVEL), device=device)
    bm, _, _ = bm.center_and_scale_to_unit_sphere()
    Kb = pinhole_K(BATCH_SIZE)
    with torch.no_grad():
        fd0 = trt.setup_faces(bm.extend(BATCH_VIEWS),
                              trt.PerspectiveCamera.from_K(
                                  Kb, (H, W), R=R_all, t=t_all,
                                  device=device))
        mx, _ = count_overflow(fd0, (H, W), BATCH_TILE, 0, 0.0)
        mfb = max(8, int(float(mx) * 1.3))
        act = suggest_active_tiles_fd(fd0, (H, W), BATCH_TILE, 0.0)
        split = suggest_occupancy_split_fd(fd0, (H, W), BATCH_TILE, 0.0, act,
                                           mfb)
        del fd0
        st = trt.RasterizationSettings(
            (H, W), bin_size=BATCH_TILE, max_faces_per_bin=mfb,
            active_tiles=act, occupancy_split=split, select_impl="affine",
            check_budgets="off")
        fp12 = trt.setup_face_planes(
            bm.extend(BATCH_CHUNK), trt.PerspectiveCamera.from_K(
                Kb, (H, W), R=R_all[:BATCH_CHUNK], t=t_all[:BATCH_CHUNK],
                device=device))
        inp = cuda_hard.binned_inputs(fp12, st)
    args = (inp.slab, inp.count, inp.origin, BATCH_TILE, inp.inv_s, 0.0,
            st.znear, st.clip_bary)
    times("hard_k1_depth_call", lambda: cuda_hard.hard_k1(*args),
          "hard_k1_kernel")
    out["hard_k1_depth_call"]["shape"] = list(inp.slab.shape)
    # points_select at the point bench slab (uniform r^2)
    from torch_renderer_tpu_torch.rasterize.points import (
        PointsRasterizationSettings,
    )

    cloud, Kc, Rc, tc, bud = points_scene(device)
    ccam = trt.AlphaPointRender(Kc, (POINTS_IMAGE, POINTS_IMAGE),
                                device=device).camera_with_pose(Rc, tc)
    pst = PointsRasterizationSettings(
        (POINTS_IMAGE, POINTS_IMAGE), radius=POINTS_RADIUS, bin_size=16,
        max_points_per_bin=bud["mpb"])
    with torch.no_grad():
        qq, z, valid = project_points_screen(cloud, ccam, pst.znear)
        r2 = POINTS_RADIUS * POINTS_RADIUS
        pin = cuda_points.binned_point_inputs(
            qq, z, valid, torch.full_like(z, r2), pst, uniform_r2=r2)
    pargs = (pin.slab, pin.count, pin.origin, pin.offs, 8, pst.znear, r2)
    times("points_select_bench", lambda: cuda_points.points_select(*pargs),
          "points_select_kernel")
    sph = trt.PulsarRenderer(Kc, (POINTS_IMAGE, POINTS_IMAGE),
                             radius=POINTS_RADIUS, bin_size=16,
                             max_points_per_bin=bud["mpb_sphere"],
                             active_tiles=bud["act_sphere"], device=device)
    with torch.no_grad():
        cam_s = sph.camera_with_pose(Rc, tc)
        _, _, r_ndc = sph._selection_radii(cloud, cam_s)
        qq, z, valid = project_points_screen(cloud, cam_s, sph.settings.znear)
        pin = cuda_points.binned_point_inputs(qq, z, valid, r_ndc * r_ndc,
                                              sph.settings)
    sargs = (pin.slab, pin.count, pin.origin, pin.offs, 8,
             sph.settings.znear, pin.r2)
    times("points_select_per_point",
          lambda: cuda_points.points_select(*sargs), "points_select_kernel")
    out["points_select_per_point"]["shape"] = list(pin.slab.shape)
    # topk_select at the joint fit's K=8 slab (2 views)
    fitter, src, _, _, ds = joint_setup(device, 1)
    jst = fitter.renderer.settings
    with torch.no_grad():
        jinp = cuda_hard.binned_inputs(trt.setup_face_planes(
            src.extend(2), fitter.renderer.camera_with_pose(ds["R"][:2],
                                                            ds["t"][:2])),
            jst)
    jargs = (jinp.slab, jinp.count, jinp.origin, jst.faces_per_pixel,
             jst.bin_size, jinp.inv_s, jst.blur_radius, jst.znear)
    times("topk_select_joint_k8", lambda: cuda_hard.topk_select(*jargs),
          "topk_select")
    out["topk_select_joint_k8"]["shape"] = list(jinp.slab.shape)
    del fitter, ds, jinp, jargs
    # hard_k1 at the FD fit's 12-view call and at a COCO chunk
    from torch_renderer_tpu_torch.opt.pose_fit_fd import _fd_rows

    fitter, fmeshes, _, start, _ = fd_setup(device)
    Rf, tf = fitter.unpack(_fd_rows(start, fitter.config.eps))
    fst = fitter.renderer.resolved_settings(fmeshes, Rf[:1], tf[:1])
    gen, scene, rng = coco_scene(device, material_mode="texture", room=True,
                                 min_visible_px=200, edge_maps=True)
    cb, cR, ct, _ = coco_chunk_inputs(gen, scene, rng)
    for tag, meshes_, cam_, st_ in (
            ("fd", fmeshes.extend(Rf.shape[0]),
             fitter.renderer.camera_with_pose(Rf, tf), fst),
            ("coco", cb, gen.renderer.camera_with_pose(cR, ct),
             gen.renderer.settings)):
        with torch.no_grad():
            kin = cuda_hard.binned_inputs(trt.setup_face_planes(meshes_,
                                                                cam_), st_)
        kargs = (kin.slab, kin.count, kin.origin, st_.bin_size, kin.inv_s,
                 st_.blur_radius, st_.znear, st_.clip_bary)
        times(f"hard_k1_{tag}", lambda: cuda_hard.hard_k1(*kargs),
              "hard_k1_kernel")
        out[f"hard_k1_{tag}"]["shape"] = list(kin.slab.shape)
    print(f"[old shapes] ({card}): " + "; ".join(
        f"{k} {v['ms']:.4f} / {v['device_ms']} ms"
        + (f" {v['shape']}" if "shape" in v else "") for k, v in out.items()),
        flush=True)
    return out


def wide_phase(device, card: str) -> dict:
    """M: the counted main path at the new shapes (wide_main_path), the
    kernels against their plain versions there (wide_checks; each with
    its launches on the main path, WIDE_ROWS), and the widened kernels at
    the old shapes (old_shape_times)."""
    main_path = wide_main_path(device, card)
    checks = wide_checks(device, card, main_path["depth_app"]["budgets"])
    for name, rec in checks.items():
        parts = ([("fwd", rec["fwd"]), ("bwd", rec["bwd"])]
                 if name.startswith("soft") else [("", rec)])
        for sub, r in parts:
            row = f"{name} {sub}" if sub else name
            r["launches"] = row_launches(main_path["cases"], row)
            print(f"[wide] {row}: shape {rec.get('shape')}, events "
                  f"{r['ms']:.4f} ms, alone {r['device_ms']} ms, launches "
                  f"{r['launches']} (main path), bound {r['bound_ms']:.6f} "
                  f"ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms; "
                  f"{card}", flush=True)
    return {"main_path": main_path, "checks": checks,
            "old_shapes": old_shape_times(device, card)}


# ---------------------------------------------------------------------------
# N. the deform app (BASELINE.json config 3) on the card
# ---------------------------------------------------------------------------

DEFORM_BOUND = 1.5   # every fitted vertex within this radius of the origin
DEFORM_EAGER_ITERS = 500   # the eager app's shorter window
DRAWS = 4            # StepGraph calls of the sampling check


def deform_app_run(argv: list, form: str, card: str) -> dict:
    """apps/deform_from_pcd.main with argv (and --eager for the eager
    form), with tests/test_torch_deform.py's gates: every chamfer finite,
    the last below 0.5x the first (the target-mesh test's gate), and the
    fitted mesh bounded (every vertex within DEFORM_BOUND of the origin;
    source and target lie within the unit sphere). Its iterations a
    second as the app prints them (its clock times the whole fit, the
    warm-up and capture included), its peak device memory."""
    import io
    import re
    import shutil

    from torch_renderer_tpu_torch.apps import deform_from_pcd
    from torch_renderer_tpu_torch.io.obj import load_obj

    out_dir = os.path.join("build", f"deform_smoke_{form}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cham, mb = peak_mb(lambda: deform_from_pcd.main(
            ["--device", "cuda", "--out-dir", out_dir] + argv
            + (["--eager"] if form == "eager" else [])))
    log = buf.getvalue()
    print(log, end="", flush=True)
    verts = load_obj(os.path.join(out_dir, "geometry_result.obj")).verts
    radius = float(torch.as_tensor(verts).norm(dim=-1).max())
    shutil.rmtree(out_dir, ignore_errors=True)
    it_s = float(re.search(r"= ([0-9.]+) iters/sec", log).group(1))
    print(f"[deform] app, {form}{' ' + ' '.join(argv) if argv else ''}: "
          f"chamfer {cham[0]:.5f} -> {cham[-1]:.5f}, largest vertex radius "
          f"{radius:.4f} (bound {DEFORM_BOUND}), {it_s:.1f} it/s (the app's "
          f"clock: the fit, warm-up and capture included), peak {mb:.1f} "
          f"MiB ({card})", flush=True)
    if not (np.isfinite(cham).all() and cham[-1] < 0.5 * cham[0]
            and radius < DEFORM_BOUND):
        raise AssertionError(f"deform app {form}: the fit failed its gates")
    return {"chamfer": [float(cham[0]), float(cham[-1])], "radius": radius,
            "it_s": it_s, "iters": int(len(cham)), "peak_mb": mb,
            "history": cham}


def replay_draws(device, card: str) -> dict:
    """A StepGraph of one surface sampling (sample_points_from_meshes of
    the deform app's level-4 source, 1000 samples, from a seeded CUDA
    generator registered with the graph) called DRAWS times against the
    same sampling eager from a generator of the same seed: call k's
    points equal eager's k-th draw bit for bit, consecutive calls differ,
    and the generator's offset moves as eager's does after each call."""
    import torch_renderer_tpu_torch as trt
    from torch_renderer_tpu_torch.ops.sample_points import (
        sample_points_from_meshes,
    )
    from torch_renderer_tpu_torch.utils.graph import StepGraph

    mesh = trt.Meshes.from_single(*trt.icosphere(4), device=device)
    gens = {f: torch.Generator(device=device).manual_seed(11)
            for f in ("captured", "eager")}
    buf = torch.empty((1, 1000, 3), device=device)

    def step():
        buf.copy_(sample_points_from_meshes(mesh, 1000, gens["captured"]))

    graph = StepGraph(step, device, True, (gens["captured"],))
    got, want, offsets = [], [], []
    for _ in range(DRAWS):
        graph()
        got.append(buf.clone())
        want.append(sample_points_from_meshes(mesh, 1000, gens["eager"]))
        offsets.append([gens[f].get_offset() for f in ("captured",
                                                       "eager")])
    graph.release()
    equal = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
    differ = [not bool(torch.equal(got[k], got[k + 1]))
              for k in range(DRAWS - 1)]
    rec = {"equal_to_eager": equal, "consecutive_differ": differ,
           "offsets": offsets,
           "register_generator_state": hasattr(torch.cuda.CUDAGraph,
                                               "register_generator_state")}
    print(f"[deform] sampling as a StepGraph (warm-up, capture + replay, "
          f"replays) against eager draws: {rec} ({card})", flush=True)
    if not (all(equal) and all(differ)
            and all(a == b for a, b in offsets)):
        raise AssertionError("the captured sampling does not draw as eager "
                             "does")
    return rec


def fit_forms(tag: str, run_fit, n_profile: int, card: str,
              expect: dict, prologue=None) -> dict:
    """run_fit(captured, n) in both forms for n_profile iterations: the
    captured fit's replays without a host sync, its kernels against the
    eager fit's (same_kernels; prologue: rng_prologue's record, for a
    fit that draws from a registered generator), each form's busy share and peak memory."""
    with replays_without_sync() as n_rep:
        run_fit(True, n_profile)
    if n_rep[0] != n_profile - 1:
        raise AssertionError(f"{tag}: {n_rep[0]} replays of {n_profile} "
                             "iterations")
    kern = same_kernels(tag, lambda c: run_fit(c, n_profile), expect,
                        prologue)
    prof = {}
    for form in ("captured", "eager"):
        prof[form], mb = peak_mb(lambda: _busy_share(
            lambda: run_fit(form == "captured", n_profile), n_profile))
        prof[form]["peak_mb"] = mb
        print(f"[{tag}] {form}, a {n_profile}-iteration fit profiled (its "
              f"first iteration and the capture included): busy "
              f"{prof[form]['busy_ms_per_iter']:.4f} ms of "
              f"{prof[form]['wall_ms_per_iter']:.4f} wall ms an iteration "
              f"(share {prof[form]['busy_share']:.3f}), "
              f"{prof[form]['kernels_per_iter']} kernels an iteration, peak "
              f"{mb:.1f} MiB ({card})", flush=True)
    return {"kernels": kern, "profile": prof}


def close_start(tag: str, hc: dict, he: dict, metric: str) -> float:
    """Gate: the captured fit's first two metrics within 1e-4 (relative)
    of the eager fit's (the same draws and parameters; float32 atomics in
    the backward part them in their last bits later)."""
    a, b = (torch.as_tensor(h[metric][:2]).double() for h in (hc, he))
    err = float(((a - b).abs() / b.abs().clamp_min(1e-6)).max())
    print(f"[{tag}] {metric} captured {a.tolist()} eager {b.tolist()}: "
          f"relative err {err:.2e}", flush=True)
    if not err <= 1e-4:
        raise AssertionError(f"{tag}: the captured fit's first steps differ "
                             f"from eager's by {err}")
    return err


def deform_phase(device, card: str) -> dict:
    """N: apps/deform_from_pcd.main at its defaults (level 4, 1000
    samples, 2000 iterations), captured (the default), and eager for
    DEFORM_EAGER_ITERS iterations, each with the app's gates; their first
    two chamfers within 1e-4 (the same draws: the generator is registered
    with the graph); the sampling check (replay_draws); a 22-iteration fit
    of the app's problem in both forms, profiled (fit_forms)."""
    import torch_renderer_tpu_torch as trt
    from torch_renderer_tpu_torch.opt.deform import DeformConfig, MeshDeformer

    captured = deform_app_run([], "captured", card)
    eager = deform_app_run(["--iters", str(DEFORM_EAGER_ITERS)], "eager",
                           card)
    err = close_start("deform app", {"chamfer": captured.pop("history")},
                      {"chamfer": eager.pop("history")}, "chamfer")
    draws = replay_draws(device, card)
    verts, faces = trt.icosphere(4)
    src = trt.Meshes.from_single(verts, faces, device=device)
    tgt = trt.Meshes.from_single(verts * np.float32([1.0, 0.6, 0.4]), faces,
                                 device=device)
    deformer = MeshDeformer(src, target_meshes=tgt, config=DeformConfig())
    forms = fit_forms(
        "deform fit",
        lambda c, n: deformer.fit(
            torch.Generator(device=device).manual_seed(0), n_steps=n,
            capture=c), PROFILE_ITERS + 2, card, {},
        rng_prologue(device, card))
    for k, rec in (("captured", captured), ("eager", eager)):
        rec["busy_share"] = forms["profile"][k]["busy_ms_per_iter"] \
            * rec["it_s"] / 1e3
    return {"captured": captured, "eager": eager, "first_err": err,
            "draws": draws, **forms, "it_s": captured["it_s"],
            "chamfer": captured["chamfer"]}


# ---------------------------------------------------------------------------
# O. the two-phase creator (opt/creator.py) at CreatorConfig's defaults
# ---------------------------------------------------------------------------

CREATOR_EAGER_GEOMETRY = 200   # the eager forms' shorter windows
CREATOR_EAGER_COLOR = 50
OBJ_RGB_TOL = 5e-5 * (1 + 1e-6)  # save_obj writes colours to 4 decimals


def creator_target(device):
    """The deform app's target (the level-4 icosphere scaled by (1, 0.6,
    0.4)) coloured as tests/test_creator.py colours its target
    (clip(0.5 + 0.5 * v)), and the level-4 icosphere as the source."""
    import torch_renderer_tpu_torch as trt
    from torch_renderer_tpu_torch.structures.textures import TexturesVertex

    verts, faces = trt.icosphere(4)
    tv = (verts * np.float32([1.0, 0.6, 0.4])).astype(np.float32)
    rgb = np.clip(0.5 + 0.5 * tv, 0.0, 1.0).astype(np.float32)
    target = dataclasses.replace(
        trt.Meshes.from_single(tv, faces, device=device),
        textures=TexturesVertex(torch.as_tensor(rgb, device=device)[None]))
    return trt.Meshes.from_single(verts, faces, device=device), target


def obj_colors(path: str) -> np.ndarray:
    """The r g b columns of an OBJ's xyzrgb v lines."""
    with open(path) as f:
        rows = [line.split()[4:7] for line in f if line.startswith("v ")]
    return np.asarray(rows, np.float64)


def creator_color_checks(creator, launches: dict, card: str) -> dict:
    """The colour fit's kernels (topk_select K=4, gather_tiles_fwd,
    untile_scatter) against their plain versions on the fit's own binned
    inputs: the creator's deformed mesh under its colour views (10 at
    128x128), with the settings the fit resolves (VertexColorFitter.fit's
    prepare: the auto resolution that the reference views' render of the
    target cached, as the mesh sizes and settings are the same). Each
    record holds the main run's colour phase launches (launches), all at
    these settings: the reference render's and the fit's warm-up and
    capture."""
    import torch_renderer_tpu_torch as trt
    from torch_renderer_tpu_torch.cameras.look_at import (
        look_at_view_transform,
    )
    from torch_renderer_tpu_torch.opt.deform import VertexColorFitter
    from torch_renderer_tpu_torch.rasterize import cuda_hard

    cfg = creator.config
    device = creator.deformed.device
    azims = torch.linspace(-180.0, 180.0, cfg.n_color_views + 1)[:-1]
    Rs, ts = look_at_view_transform(cfg.view_dist, cfg.view_elev, azims)
    Rs, ts = Rs.to(device), ts.to(device)
    fitter = VertexColorFitter(creator.K, cfg.image_size, cfg.color,
                               device=device)
    meshes = fitter._views_batch(creator.deformed, cfg.n_color_views)
    st = fitter.renderer.prepare(meshes, Rs, ts)
    with torch.no_grad():
        fp = trt.setup_face_planes(meshes,
                                   fitter.renderer.camera_with_pose(Rs, ts))
        inp = cuda_hard.binned_inputs(fp, st)
    out = {"topk_select": topk_check("creator colour fit", inp, st),
           "gather_tiles_fwd": gather_check(
               "creator colour fit slab", *_slab_gather_inputs(inp), card,
               bwd=False)}
    with torch.no_grad():
        bins, fields = cuda_hard.binned_tile_fields(fp, st)
        out["untile_scatter"], _ = untile_check(
            "creator colour fit", bins, fields, tuple(cfg.image_size),
            st.bin_size, card)
    out["untile_scatter"].update(max_abs_err=0.0,
                                 shape=list(inp.slab.shape))
    for name, rec in out.items():
        rec["launches"] = launches[name]
        print(f"[creator] colour fit's {name} at {rec['shape']} (tile "
              f"{st.bin_size}, K={st.faces_per_pixel}): kernel "
              f"{rec['ms']:.4f} ms (device {rec['device_ms']} ms), plain "
              f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.6f} ms "
              f"({rec['bound_by']}), {rec['launches']} launches in the "
              f"captured colour phase ({card})", flush=True)
    return out


def creator_phase(device, card: str) -> dict:
    """O: TwoPhaseCreator at CreatorConfig's defaults (geometry 4000 SGD
    steps of 1000 samples; colour 500 steps over 10 views at 128x128, K=4)
    from the level-4 icosphere onto the deform app's coloured target,
    captured (the default), each phase counted, with the JAX tests' gates
    (tests/test_creator.py): the chamfer's last value below 0.5x its
    first, the RGB error finite and falling, the OBJ export round-trips
    (vertices within 1e-5, faces equal, colours in [0, 1] and within
    the writer's 4 decimals), the direct colour transfer in
    [0, 1]. Then each phase eager for a shorter window against the
    captured phase over the same window (first two metrics within 1e-4;
    the colour phases on one geometry), and both phases' forms profiled
    (fit_forms)."""
    import shutil

    from torch_renderer_tpu_torch.io.obj import load_obj
    from torch_renderer_tpu_torch.opt.creator import (
        CreatorConfig,
        TwoPhaseCreator,
    )
    from torch_renderer_tpu_torch.rasterize import autotune
    from torch_renderer_tpu_torch.rasterize.binning import (
        set_budget_check_default,
    )

    src, target = creator_target(device)
    cfg = CreatorConfig()

    def run(form, n_geo=None, n_col=None, creator=None,
            phases=("geometry", "color")):
        """A creator's phases in one form (on a new creator, or the colour
        phase on a given one's geometry): (creator, per phase its outputs,
        rates by events and by the host clock, launches and peak)."""
        creator = creator or TwoPhaseCreator(src, target, cfg)
        capture = form == "captured"
        rec = {}
        for name, fn in (
                ("geometry", lambda: creator.geometry_train(
                    torch.Generator(device=device).manual_seed(0),
                    n_steps=n_geo, capture=capture)),
                ("color", lambda: creator.color_train(n_steps=n_col,
                                                      capture=capture))):
            if name not in phases:
                continue
            reset_counts()
            (out, events_s, wall_s), mb = peak_mb(lambda: timed(fn))
            n = out["history"]["loss"].shape[0]
            rec[name] = {"out": out, "iters": n, "it_s_events": n / events_s,
                         "it_s_wall": n / wall_s, "launches": read_counts(),
                         "peak_mb": mb}
            print(f"[creator] {name}, {form}: {n} iterations, "
                  f"{n / events_s:.1f} it/s by CUDA events, "
                  f"{n / wall_s:.1f} by the host clock (the phase whole, "
                  f"set-up, warm-up and capture included), peak {mb:.1f} "
                  f"MiB, launches {rec[name]['launches']} ({card})",
                  flush=True)
        return creator, rec

    creator, main_run = run("captured")
    geo, col = main_run["geometry"], main_run["color"]
    cham = geo["out"]["history"]["chamfer"].cpu().numpy()
    mse = col["out"]["history"]["rgb_mse"].cpu().numpy()
    out_dir = os.path.join("build", "creator_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "result.obj")
    creator.export(path)
    back = load_obj(path)
    v, f = creator.deformed.detach_to_lists()[0]
    rgb = obj_colors(path)
    want = np.clip(creator.verts_rgb.cpu().numpy(), 0, 1)[:v.shape[0]]
    round_trip = {
        "verts_err": float(np.abs(back.verts - v).max()),
        "faces_equal": bool(np.array_equal(back.faces, f)),
        "colors_err": float(np.abs(rgb - want).max()),
        "colors_in_range": bool(rgb.min() >= 0 and rgb.max() <= 1)}
    shutil.rmtree(out_dir, ignore_errors=True)
    transfer = creator.transfer_colors()
    transfer_range = [float(transfer.min()), float(transfer.max())]
    gates = {"chamfer": [float(cham[0]), float(cham[-1])],
             "rgb_mse": [float(mse[0]), float(mse[-1])],
             "rgb_mse_finite": bool(np.isfinite(mse).all()),
             "round_trip": round_trip, "transfer_range": transfer_range}
    print(f"[creator] CreatorConfig defaults, captured: {gates} ({card})",
          flush=True)
    lc = col["launches"]
    if not (np.isfinite(cham).all() and cham[-1] < 0.5 * cham[0]
            and np.isfinite(mse).all() and mse[-1] < mse[0]
            and round_trip["verts_err"] <= 1e-5
            and round_trip["faces_equal"]
            and round_trip["colors_err"] <= OBJ_RGB_TOL
            and round_trip["colors_in_range"]
            and 0.0 <= transfer_range[0] and transfer_range[1] <= 1.0):
        raise AssertionError(f"creator: the gates failed: {gates}")
    if any(geo["launches"].values()) or lc != only(
            lc, topk_select=lc["topk_select"],
            gather_tiles_fwd=lc["topk_select"],
            untile_scatter=lc["topk_select"]) or lc["topk_select"] < 1:
        raise AssertionError(f"creator: launches {geo['launches']} / {lc}")
    color_checks = creator_color_checks(creator, lc, card)
    # the eager forms over shorter windows, against the captured phases
    # over the same windows; the colour phase of both forms on one
    # geometry (two geometry fits part in their last bits: float32
    # atomics in the backward)
    windows, shared = {}, None
    for form in ("captured", "eager"):
        creator_w, windows[form] = run(form, CREATOR_EAGER_GEOMETRY,
                                       phases=("geometry",))
        shared = shared or creator_w
    for form in ("captured", "eager"):
        windows[form].update(run(form, n_col=CREATOR_EAGER_COLOR,
                                 creator=shared, phases=("color",))[1])
    errs = {name: close_start(f"creator {name}",
                              windows["captured"][name]["out"]["history"],
                              windows["eager"][name]["out"]["history"],
                              metric)
            for name, metric in (("geometry", "chamfer"),
                                 ("color", "rgb_mse"))}
    # both phases' forms profiled, budget checks off (as phase H profiles
    # the pose fits): the colour fit's auto budgets check "warn" by
    # default, read once after the loop, inside replays_without_sync's
    # window
    set_budget_check_default("off")
    autotune.clear_cache()
    creator_p = TwoPhaseCreator(src, target, cfg)
    creator_p.geometry_train(torch.Generator(device=device).manual_seed(0),
                             n_steps=1, capture=False)
    profiles = {
        "geometry": fit_forms(
            "creator geometry", lambda c, n: creator_p.geometry_train(
                torch.Generator(device=device).manual_seed(0), n_steps=n,
                capture=c), PROFILE_ITERS + 2, card, {},
            rng_prologue(device, card)),
        "color": fit_forms(
            "creator color", lambda c, n: creator_p.color_train(
                n_steps=n, capture=c), PROFILE_ITERS + 2, card,
            {k: PROFILE_ITERS + 2 for k in ("topk_select",
                                            "gather_tiles_fwd",
                                            "untile_scatter")})}
    set_budget_check_default(None)
    autotune.clear_cache()

    def summary(rec):
        return {k: v for k, v in rec.items() if k != "out"}

    return {"gates": gates, "captured": {k: summary(r)
                                         for k, r in main_run.items()},
            "windows": {f: {k: summary(r) for k, r in w.items()}
                        for f, w in windows.items()},
            "first_err": errs, "color_checks": color_checks, **profiles}


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
                         "untile_kernel", "texsample", "svd3")):
            print(f"ptxas {k}: {v.get('registers')} registers, "
                  f"{v.get('smem')} bytes static smem, spill stores "
                  f"{v.get('spill_stores')} / loads {v.get('spill_loads')} "
                  "bytes", flush=True)

    phase_s = {}

    def timed_phase(name, fn, *args):
        """fn(*args), its seconds by the host clock into phase_s."""
        t_start = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t_start
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)
        return out

    soft_gather, kernels = timed_phase("A", soft_phase, device, card)
    hard = timed_phase("B", hard_phase, device, card)
    fits = timed_phase("C", lambda: {
        route: pose_fit_phase(device, card, route)
        for route in ("fragments", "pallas")})
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
    tex = timed_phase("D", texture_phase, device, card)
    joint = timed_phase("E", joint_fit_phase, device, card)
    pts = timed_phase("F", points_phase, device, card)
    batch = timed_phase("G", batch_phase, device, card)
    captured = timed_phase("H", captured_phase, device, card)
    apps = timed_phase("I", depth_apps_phase, device, card)
    reg = timed_phase("J", registration_phase, device, card)
    cocok = timed_phase("K", coco_phase, device, card)
    multi = timed_phase("L", multicard_phase, card)
    wide = timed_phase("M", wide_phase, device, card)
    deform = timed_phase("N", deform_phase, device, card)
    creator = timed_phase("O", creator_phase, device, card)
    print(f"phases' seconds (host clock, {card}): "
          + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
          + f"; build {build_s:.1f}", flush=True)

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
         "launches_fd_fit": reg["fd"]["launches_eager"]["hard_k1"],
         "fd_fit_call": {k: reg["fd"]["hard_k1"][k] for k in (
             "shape", "live", "max_abs_err", "ms", "device_ms", "plain_ms",
             "bound_ms", "bound_by", "bound_every_pair_ms")},
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
         "launches_twin": _twin_launches(pts["twin"], "points_select"),
         "ptxas": ptxas.get("points_select_kernel")})
    g7, gs = batch["gather"], soft_gather
    source = "torch_renderer_tpu_torch/csrc/gather_tiles.cu"
    kernels += [
        {"name": "gather_tiles_fwd", "route": "cuda", "source": source,
         "replaces": "torch_renderer_tpu/rasterize/pallas_gather.py:129",
         "launches": batch["counts"]["gather_tiles_fwd"],
         "launches_twin": _twin_launches(pts["twin"], "gather_tiles_fwd"),
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
         "launches_fd_fit": reg["fd"]["launches_eager"]["gather_tiles_fwd"],
         "fd_fit_call": {k: reg["fd"]["gather"][k] for k in (
             "shape", "live", "ms", "device_ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms", "library_device_ms")},
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
         "launches_fd_fit": reg["fd"]["launches_eager"]["untile_scatter"],
         "fd_fit_call": {k: reg["fd"]["untile"][k] for k in keys},
         "ptxas": ptxas.get("untile_kernel")})
    sv = reg["icp"]["svd3"]
    kernels.append(
        {"name": "svd3", "route": "cuda",
         "source": "torch_renderer_tpu_torch/csrc/svd3.cu",
         "replaces": "torch_renderer_tpu/ops/icp.py:68",
         "pallas_site": None,
         "launches": reg["icp"]["app_launches"]["svd3"],
         "launches_eager_icp": reg["icp"]["launches_eager"]["svd3"],
         **{k: sv[k] for k in (
             "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms", "library_device_ms", "shape",
             "rotation_err_vs_library", "s_err_vs_library")},
         "ptxas": ptxas.get("svd3_kernel")})
    byname = {k["name"]: k for k in kernels}
    runs = ("defaults", "textured")

    def coco_launches(name):
        return {f"{r}_{f}": cocok[f"{r}_forms"][f]["launches"][name]
                for r in runs for f in ("captured", "eager")}

    def pick(rec, keys):
        return {k: rec[k] for k in keys}

    hk = cocok["hard_k1"]
    byname["hard_k1"]["coco_chunk"] = {
        **pick(hk, ("shape", "live", "max_count", "max_abs_err", "ms",
                    "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "bound_every_pair_ms", "box_pairs", "pairs")),
        "library_ms": None, "launches": coco_launches("hard_k1")}
    gk = cocok["gather"]
    byname["gather_tiles_fwd"]["coco_chunk"] = {
        **pick(gk, ("shape", "live", "rows", "max_abs_err", "ms",
                    "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_device_ms")),
        "launches": coco_launches("gather_tiles_fwd")}
    uk = cocok["untile"]
    byname["untile_scatter"]["coco_chunk"] = {
        **pick(uk, ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_device_ms")),
        "max_abs_err": 0.0, "per_call_of": "the 4 fields of one 8-view "
        "480x640 chunk", "launches": coco_launches("untile_scatter")}
    tk = cocok["tex"]
    byname["texsample_fwd"]["coco_chunk"] = {
        "shape": tk["shape"], "map_batch_stride": tk["map_batch_stride"],
        "live_points": tk["live_points"], "texels": tk["texels"],
        "max_abs_err": tk["fwd_err"], "ms": tk["times"]["fwd"],
        "device_ms": tk["times"]["fwd_device"],
        "plain_ms": tk["times"]["fwd_plain"],
        "bound_ms": tk["bound_fwd"]["bound_ms"],
        "bound_by": tk["bound_fwd"]["bound_by"],
        "library_ms": tk["times"]["fwd_library"],
        "library_device_ms": tk["times"]["fwd_library_device"],
        "launches": coco_launches("texsample_fwd")}
    # phase L: each kernel's launches on every rank under sharding
    paths = ("silhouette", "bench", "icp", "points", "coco", "fit")
    for name, entry in byname.items():
        per_rank = [{p: r[p]["counts"][name] for p in paths
                     if r[p]["counts"][name]} for r in multi["per_rank"]]
        if any(per_rank):
            entry["sharded"] = {"form": multi["form"],
                                "launches_per_rank": per_rank}
    sil_l = multi["per_rank"][0]["silhouette"]
    for name in ("soft_coverage_fwd", "soft_coverage_bwd",
                 "gather_tiles_fwd", "gather_tiles_bwd"):
        byname[name]["sharded"].update(
            silhouette_call_ms=sil_l["ms"],
            single_rank_call_ms=sil_l["single_ms"],
            alpha_err=sil_l["alpha_err"], grad_err=sil_l["grad_err"])
    # phase M: each widened kernel at the new shapes, launches from its
    # counted main path
    keys = ("shape", "max_abs_err", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "bound_every_pair_ms", "launches")
    for name, rec in wide["checks"].items():
        if name.startswith("soft"):
            for key in ("fwd", "bwd"):
                byname[f"soft_coverage_{key}"].setdefault("wide", {})[name] = {
                    **{k: rec[key].get(k) for k in keys},
                    "shape": rec["shape"]}
        else:
            byname[name.split("_tile")[0]].setdefault("wide", {})[name] = {
                **{k: rec.get(k) for k in keys},
                **{k: rec[k] for k in ("plan", "device_lists") if k in rec}}
    # phase O: the creator's colour fit's kernels at its own slab, with
    # their launches in the captured colour phase (the fit's warm-up and
    # capture); the depth app and COCO captured: their launches (each
    # graph's warm-up and capture)
    for name, rec in creator["color_checks"].items():
        byname[name]["creator_color"] = {
            k: rec.get(k) for k in keys + ("library_ms",)}
    for name in ("hard_k1", "gather_tiles_fwd", "untile_scatter"):
        byname[name]["launches_depth_app_captured"] = \
            batch["forms"]["captured"]["launches"][name]
    for r in runs:
        f = cocok[f"{r}_forms"]
        print(f"coco data generator, {r} ({card}): " + "; ".join(
            f"{form} {f[form]['images']} images in {f[form]['seconds']:.2f} "
            f"s = {f[form]['images_per_s']:.1f} images/s, "
            f"{f[form]['s_per_scene']:.3f} s a scene, "
            f"{f[form]['annotations']} annotations (min area "
            f"{f[form]['min_area']}), peak {f[form]['peak_gb']:.3f} GiB"
            for form in ("captured", "eager"))
            + f"; {f['same']['files']} files equal", flush=True)
    for config in ("", "_textured"):
        busy = [cocok["scene_profile" + config + f]["busy_share"]
                for f in ("", "_eager")]
        print(f"coco, a scene of the {config[1:] or 'defaults'} ({card}): "
              f"busy share captured {busy[0]:.3f}, eager {busy[1]:.3f}",
              flush=True)
    ct, ce = cocok["chunk_times"], cocok["chunk_times_eager"]
    print(f"coco, a textured room chunk ({card}): device ms captured / eager "
          f"{ct['device_ms']:.3f} / {ce['device_ms']:.3f}, the visibility "
          f"count's {ct['vis_device_ms']:.3f} / {ce['vis_device_ms']:.3f}",
          flush=True)
    for form, r in batch["forms"].items():
        print(f"batch depth render, {form} ({card}): {r['images_per_s']:.1f} "
              f"images/s batched, {r['serial_images_per_s']:.1f} serial, "
              f"busy share {r['busy_share']:.3f}, peak {r['peak_gb']:.3f} "
              f"GiB; one eager call {batch['call_ms']} ms", flush=True)
    tw = pts["twin"]
    print(f"point twin, ms a step captured / eager ({card}): " + "; ".join(
        f"{n} fwd {r['forward']['ms']['captured']:.3f} / "
        f"{r['forward']['ms']['eager']:.3f}, grad "
        f"{r['grad step']['ms']['captured']:.3f} / "
        f"{r['grad step']['ms']['eager']:.3f}"
        for n, r in tw["rows"].items()) + f"; busy share and peak "
        f"{tw['forms']}", flush=True)
    print(f"point renders ({card}): " + ", ".join(
        f"{n} fwd {r['fwd_ms']:.3f} / grad {r['grad_ms']:.3f} ms"
        for n, r in pts["runs"].items()), flush=True)
    print(f"pose fit it/s ({card}): " + ", ".join(
        f"{r} {f['it_s_events']:.1f} (events) / {f['it_s_wall']:.1f} (wall)"
        for r, f in fits.items()), flush=True)
    print(f"joint fit it/s ({card}): {joint['it_s_events']:.1f} (events) / "
          f"{joint['it_s_wall']:.1f} (wall)", flush=True)
    cb = captured["bench"]
    rates = {k: " / ".join(", ".join(f"{r['it_s_wall']:.1f}"
                                      for r in captured[k]["runs"][f])
                            for f in ("captured", "eager"))
             for k in ("pose_fragments", "pose_pallas", "joint")}
    print(f"captured against eager ({card}): soft step median "
          f"{cb['captured']['img_s']:.1f} / {cb['eager']['img_s']:.1f} "
          "img/s; " + "; ".join(f"{k} {r} it/s (wall)"
                                for k, r in rates.items()), flush=True)
    icp_r, fd_r = reg["icp"]["runs"], reg["fd"]["runs"]
    print(f"registration ({card}): ICP 300 x 500 x {ICP_ITERS} "
          + " / ".join(", ".join(f"{r['events_s']:.4f}" for r in icp_r[f])
                       for f in ("captured", "eager"))
          + " s (captured / eager, events); FD fit "
          + " / ".join(", ".join(f"{r['steps_s_events']:.1f}"
                                 for r in fd_r[f])
                       for f in ("captured", "eager"))
          + " steps/s (captured / eager, events)", flush=True)
    print(f"deform app ({card}): captured {deform['it_s']:.1f} it/s "
          f"(2000 iterations), eager {deform['eager']['it_s']:.1f} "
          f"({DEFORM_EAGER_ITERS}); chamfer {deform['chamfer'][0]:.5f} -> "
          f"{deform['chamfer'][1]:.5f}", flush=True)
    print(f"two-phase creator ({card}): " + "; ".join(
        f"{name} captured {creator['captured'][name]['it_s_wall']:.1f} it/s "
        f"({creator['captured'][name]['iters']} it.), window "
        + " / ".join(f"{creator['windows'][f][name]['it_s_wall']:.1f}"
                     for f in ("captured", "eager"))
        + " it/s (captured / eager)" for name in ("geometry", "color")),
        flush=True)
    print(json.dumps({"captured": captured, "depth_apps": apps,
                      "registration": reg, "coco": cocok,
                      "multicard": multi, "wide_bins": wide,
                      "deform": deform, "creator": creator,
                      "batch": {k: batch[k] for k in (
                          "forms", "kernels", "profile",
                          "profile_captured", "views_differ",
                          "ray_worst")}}, default=float), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

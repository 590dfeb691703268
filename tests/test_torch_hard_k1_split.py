"""A CPU model of the K = 1 hard kernel's decomposition (csrc/hard_raster.cu
``hard_k1_kernel``) against its plain version.

The kernel splits a tile's rows among P blocks of R rows and gives each
pixel S thread groups (``plan``, a copy of the launcher's ``k1_plan``),
hands group s the entries s, s + S, ... of each staged chunk, and lets each
warp skip every face whose grown box (``cull_boxes`` of
tests/test_torch_topk_split.py, a copy of the kernel's ``cull_box``) lies
wholly above, below, left or right of the warp's pixel span; it keeps each
group's lowest (zsel, slot) and takes the lexicographic minimum over the
groups. The model does the same in plain torch on the plain version's
priorities and must give exactly the plain version's winner slots and,
through the plain version's interpolation, all 8 of its rows bit for bit
(``hard_k1_reference``): on the seeded random slabs of the top-K model
(ties from duplicated faces and equal-depth planes, slivers, faces smaller
than a pixel, more than one staging chunk, an empty tile) at every S, on
the pose fit's scene at 128^2 and on one view of the depth app's 1280x720
call at tile 32. It also checks the cull's claim directly: every pair it
skips has priority INF. The constants are read from the kernel's source.
No JAX here.
"""

import re
from pathlib import Path

import pytest
import torch

from test_torch_topk_split import INV_S, cull_boxes, topk_slabs
from torch_renderer_tpu_torch.rasterize import cuda_hard

SOURCE = (Path(cuda_hard.__file__).resolve().parents[1] / "csrc"
          / "hard_raster.cu").read_text()


def _int_const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


CHUNK = _int_const("kK1Chunk")               # candidates staged per pass
BLOCK_PIXELS = _int_const("kK1BlockPixels")  # a block's pixels at most
MAX_THREADS = _int_const("kMaxPixels")       # a block's threads at most
MAX_GROUPS = _int_const("kK1MaxGroups")      # thread groups a pixel at most
SMS = 132                                    # an H100 SXM's SMs


def resident_64(threads: int) -> int:
    """Blocks of `threads` threads an H100 SM holds at once at 64
    registers a thread (the kernel's registers are the card's to report:
    the launcher asks the CUDA occupancy calculator)."""
    return max(1, min(2048 // threads, 65536 // (64 * threads)))


def plan(tile: int, tiles: int, sms: int = SMS, resident=resident_64):
    """(P, R, S) of a launch over `tiles` tiles, as ``k1_plan`` makes it:
    blocks of R whole rows, at most kK1BlockPixels pixels, with R halved
    (to two warps of pixels at least) while the launch has fewer blocks
    than the card has SMs; P = ceil(tile / R) blocks a tile; then the most
    groups, a power of two up to kK1MaxGroups with S * R * tile <= 1024,
    whose blocks are all resident at once (one group where R * tile is not
    whole warps)."""
    R = min(tile, max(1, BLOCK_PIXELS // tile))
    while (tiles * -(-tile // R) < sms and R % 2 == 0
           and (R // 2) * tile % 64 == 0):
        R //= 2
    P, np_ = -(-tile // R), R * tile
    S = 1
    while (np_ % 32 == 0 and 2 * S <= MAX_GROUPS
           and 2 * S * np_ <= MAX_THREADS
           and tiles * P <= resident(2 * S * np_) * sms):
        S *= 2
    return P, R, S


def warp_spans(tile: int, R: int, S: int, block: int):
    """(S * R * tile, 4) int: each thread's warp's least and greatest row
    and column, in block `block` of a tile (threads are (column, row,
    group), rows block * R on; rows past the tile are its idle threads)."""
    n = S * R * tile
    t = torch.arange(n)
    row = block * R + (t // tile) % R
    col = t % tile
    out = torch.zeros((n, 4), dtype=torch.int64)
    for w0 in range(0, n, 32):
        w = slice(w0, min(w0 + 32, n))
        out[w] = torch.stack([row[w].min(), row[w].max(), col[w].min(),
                              col[w].max()])
    return out


def _lex_min(z, slot):
    """Per row, the (z, slot) lexicographic minimum of (..., n) entries."""
    zmin = z.amin(-1, keepdim=True)
    s = torch.where(z == zmin, slot, torch.full_like(slot, 2 ** 62))
    return zmin[..., 0], s.amin(-1)


def split_k1_model(slab, count, origin, tile, inv_s, blur, znear, S=None):
    """Winner slots (B, A, tile^2) through the kernel's decomposition (-1
    where no face covers the pixel), with S groups per pixel (the
    launcher's plan when None); also returns the number of (pixel, slot)
    pairs the cull skipped, and how many winners the epilogue reads from
    the last staged chunk. Raises if the cull skips a pair whose priority
    is not INF."""
    B, A = count.shape
    tp = tile * tile
    P, R, S_plan = plan(tile, B * A)
    S = S_plan if S is None else S
    np_ = R * tile
    prio = cuda_hard._priority(slab, count, origin, tile, inv_s, blur,
                               znear)                        # (B, A, tp, F)
    F = prio.shape[-1]
    x0, x1, y0, y1 = cull_boxes(slab[:, :, :F], blur).unbind(-1)  # (B, A, F)

    def grid(o, r):
        """(B, A, n, 1) raster coordinates of rows or columns r (n,)."""
        return (o[..., None] + r.to(torch.float32) * inv_s)[..., None]

    slots = torch.arange(F)
    best_z = torch.full((B, A, tp), cuda_hard.INF)
    best_s = torch.zeros((B, A, tp), dtype=torch.int64)
    skipped = 0
    for z_ in range(P):
        pb = z_ * np_
        pix = torch.arange(pb, min(pb + np_, tp))
        span = warp_spans(tile, R, S, z_)
        zs, ss = [], []
        for g in range(S):
            r0, r1, c0, c1 = span[g * np_ + (pix - pb)].unbind(-1)  # (npix,)
            ox, oy = origin[..., 0], origin[..., 1]
            miss = ((grid(oy, r1) < y0[:, :, None])
                    | (grid(oy, r0) > y1[:, :, None])
                    | (grid(ox, c1) < x0[:, :, None])
                    | (grid(ox, c0) > x1[:, :, None]))       # (B, A, npix, F)
            mine = (slots % CHUNK) % S == g
            cull = miss & mine
            p = prio[:, :, pix]
            if bool((p[cull] < cuda_hard.INF).any()):
                raise AssertionError("the cull skipped a covering pair")
            skipped += int(cull.sum())
            z = torch.where(mine & ~cull, p, torch.full_like(p,
                                                            cuda_hard.INF))
            # a group's scan: strict < in ascending slot order
            gz, gs = _lex_min(z, slots.expand_as(z))
            zs.append(gz)
            ss.append(torch.where(gz < cuda_hard.INF, gs, 0))
        # group 0 merges the groups by (zsel, slot)
        mz, ms = _lex_min(torch.stack(zs, -1), torch.stack(ss, -1))
        best_z[:, :, pix], best_s[:, :, pix] = mz, ms
    lane = torch.where(best_z < cuda_hard.INF, best_s, -1)
    last = ((count.clamp(1, F) - 1) // CHUNK * CHUNK).long()[..., None]
    staged = int(((lane >= last) & (lane >= 0)).sum())
    return lane, skipped, staged


def model_rows(slab, count, origin, tile, inv_s, blur, znear, clip_bary,
               S=None):
    """The kernel's out (B, A, 8, tile^2) as the model computes it: its
    winners, interpolated by the plain version's arithmetic (the kernel
    repeats it op for op, from the staged face or its slab row)."""
    lane, skipped, staged = split_k1_model(slab, count, origin, tile, inv_s,
                                           blur, znear, S)
    live = lane >= 0
    zbuf, pc, dists, fid = cuda_hard._winner_values(
        slab, lane.clamp_min(0)[:, :, None], origin, tile, inv_s, clip_bary)
    rows = [zbuf, pc[0], pc[1], pc[2], dists, fid, torch.ones_like(zbuf),
            lane.clamp_min(0)[:, :, None].to(torch.float32)]
    out = torch.stack([r[:, :, 0] for r in rows], dim=2)
    empty = torch.tensor(cuda_hard.EMPTY_BAND)[:, None]
    return torch.where(live[:, :, None], out, empty), skipped, staged


def _check(slab, count, origin, tile, inv_s, blur, znear, clip, S=None):
    out, skipped, staged = model_rows(slab, count, origin, tile, inv_s,
                                      blur, znear, clip, S)
    ref = cuda_hard.hard_k1_reference(slab, count, origin, tile, inv_s,
                                      blur, znear, clip)
    assert torch.equal(out, ref)
    return ref, skipped, staged


def test_launch_rule():
    """The pose fit's 64 tiles of 16^2: 4 blocks of 4 rows a tile and 4
    groups; the depth call's 12 x 336 tiles of 32^2: 8 blocks of 4 rows,
    one group; few tiles of 8^2: one block, 4 groups; 25^2: 5 blocks of 5
    rows, one group."""
    assert plan(16, 64) == (4, 4, 4)
    assert plan(32, 12 * 336) == (8, 4, 1)
    assert plan(8, 6) == (1, 8, 4)
    assert plan(25, 6) == (5, 5, 1)
    for tile in (4, 8, 16, 25, 32):
        for tiles in (1, 6, 64, 132, 1000, 5000):
            P, R, S = plan(tile, tiles)
            assert S * R * tile <= MAX_THREADS and P * R >= tile
            assert S == 1 or R * tile % 32 == 0


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("blur", [0.0, 9.21e-4])
@pytest.mark.parametrize("tile,S", [(8, 4), (8, 1), (16, 4), (16, 2),
                                    (25, 1), (32, 4), (32, 1)])
def test_split_model_equals_plain(tile, S, blur, clip):
    F = 300 if tile <= 16 else 150       # > CHUNK: several staging passes
    slab, count, origin = topk_slabs(tile + S, 1, 3, F, tile)
    ref, skipped, staged = _check(slab, count, origin, tile, INV_S, blur,
                                  1e-5, clip, S)
    assert skipped > 0
    assert bool((ref[0, -1, 6] == 0).all())            # the empty tile
    assert staged > 0


def _pose_inputs(size, K, blur, bin_size=None):
    """The pose fit's scene (level-3 icosphere in the unit sphere,
    look_at(2.7, 15, 40)) binned as the raster bins it."""
    from torch_renderer_tpu_torch.apps.camera_pose_optimizer import pinhole_K
    from torch_renderer_tpu_torch.cameras.look_at import (
        look_at_view_transform,
    )
    from torch_renderer_tpu_torch.cameras.perspective import (
        PerspectiveCamera,
    )
    from torch_renderer_tpu_torch.ops.icosphere import icosphere
    from torch_renderer_tpu_torch.rasterize import autotune
    from torch_renderer_tpu_torch.rasterize.geometry import setup_face_planes
    from torch_renderer_tpu_torch.rasterize.raster import (
        RasterizationSettings,
    )
    from torch_renderer_tpu_torch.structures.meshes import Meshes

    meshes = Meshes.from_single(*icosphere(3), device="cpu")
    meshes, _, _ = meshes.center_and_scale_to_unit_sphere()
    R, t = look_at_view_transform(2.7, 15.0, 40.0)
    cam = PerspectiveCamera.from_K(pinhole_K(size), size, R=R[0].numpy(),
                                   t=t[0].numpy(), device="cpu")
    st = autotune.resolve_mesh_settings(
        RasterizationSettings(size, blur_radius=blur, faces_per_pixel=K,
                              bin_size=bin_size, check_budgets="off"),
        meshes, cam, margin=2.0)
    return st, cuda_hard.binned_inputs(setup_face_planes(meshes, cam), st)


def test_split_model_on_pose_scene():
    """The pallas route's K = 1 raster at the app's 128^2: 64 tiles of 16^2,
    4 blocks a tile; every winner read from the staged chunk."""
    st, inp = _pose_inputs((128, 128), 1, 0.0)
    assert st.bin_size == 16 and inp.count.shape == (1, 64)
    args = (inp.slab, inp.count, inp.origin, st.bin_size, inp.inv_s, 0.0,
            st.znear, st.clip_bary)
    ref, skipped, staged = _check(*args)
    live = int((ref[:, :, 6] > 0).sum())
    assert live > 0 and skipped > 0 and staged == live


def test_split_model_on_depth_call_view():
    """One view of the depth app's call (apps/batch_render_bench.py: the
    normalized level-3 icosphere at look_at(2.7, 15, 0), 1280x720, f = 0.9 *
    720) at its bin of 32: 8 blocks of 4 rows a tile, one group (the call's
    12 views)."""
    from torch_renderer_tpu_torch.apps._common import pinhole_K
    from torch_renderer_tpu_torch.cameras.look_at import (
        look_at_view_transform,
    )
    from torch_renderer_tpu_torch.cameras.perspective import (
        PerspectiveCamera,
    )
    from torch_renderer_tpu_torch.ops.icosphere import icosphere
    from torch_renderer_tpu_torch.rasterize.geometry import setup_face_planes
    from torch_renderer_tpu_torch.rasterize.raster import (
        RasterizationSettings,
    )
    from torch_renderer_tpu_torch.structures.meshes import Meshes

    size = (720, 1280)
    meshes = Meshes.from_single(*icosphere(3), device="cpu")
    meshes, _, _ = meshes.center_and_scale_to_unit_sphere()
    R, t = look_at_view_transform(2.7, 15.0, 0.0)
    cam = PerspectiveCamera.from_K(pinhole_K(size), size, R=R[0].numpy(),
                                   t=t[0].numpy(), device="cpu")
    # the app's budgets at its defaults: 45 faces a tile, 336 active tiles
    st = RasterizationSettings(size, faces_per_pixel=1, bin_size=32,
                               max_faces_per_bin=45, active_tiles=336,
                               check_budgets="off")
    inp = cuda_hard.binned_inputs(setup_face_planes(meshes, cam), st)
    ref, skipped, staged = _check(inp.slab, inp.count, inp.origin, 32,
                                  inp.inv_s, 0.0, st.znear, st.clip_bary,
                                  S=1)
    live = int((ref[:, :, 6] > 0).sum())
    assert live > 0 and skipped > 0 and staged == live

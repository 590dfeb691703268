"""A CPU model of the point-selection kernel's decomposition
(csrc/points_select.cu ``points_select_kernel``) against its plain version.

The kernel splits a tile's rows among P blocks of R rows and gives each
pixel S thread groups (``plans``: every (R, S) the launcher's
``points_plan`` can pick at a tile and K), hands group s the entries s,
s + S, ... of each 256-slot staged chunk, lets each warp skip every
candidate whose cull box (``splat_boxes``, a copy of the kernel's
``splat_box``) misses the box of the warp's pixels, keeps each group's K
best (z, slot) entries and merges the groups' lists in (z, slot) order. The
model does the same in plain torch on the plain version's priorities and
must give exactly the plain version's winner slots
(``points_select_reference``) on seeded slabs that hold splats centred on
pixel centres, pixels exactly on a splat's rim (d^2 == r^2), points at and
behind znear, duplicated points (ties), more than 256 candidates (two
staging chunks) and an empty tile, for K in {1, 4, 8, 64}, uniform and
per-point r^2, at tiles 8, 16 and 32, and on a small binned cloud. It
also checks the cull's claim directly: every pair it skips fails
d^2 <= r^2 (its priority is INF). The constants are read from the
kernel's source. No JAX here.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_topk_split import _lex_topk
from torch_renderer_tpu_torch.rasterize import cuda_points
from torch_renderer_tpu_torch.rasterize.binning import tile_pixel_coords

SOURCE = (Path(cuda_points.__file__).resolve().parents[1] / "csrc"
          / "points_select.cu").read_text()


def _int_const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


CHUNK = _int_const("kChunk")               # candidates staged per pass
BLOCK_PIXELS = _int_const("kBlockPixels")  # a block's pixels at most
MAX_THREADS = _int_const("kMaxPixels")     # a block's threads at most
MAX_GROUPS = _int_const("kMaxGroups")      # thread groups a pixel at most
MAX_SMEM = 232448                          # shared memory a block may use
INF = cuda_points.INF                      # the kernel's kInf
ZNEAR = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the model's tensors are small, and the suite
    runs several workers on one machine, where torch's default of one
    thread per core oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smem(threads: int, K: int) -> int:
    """A block's dynamic shared memory: the staged chunk and its boxes,
    and each thread's K entries of 8 bytes (points_smem)."""
    return 2 * CHUNK * 16 + threads * K * 8


def plans(tile: int, K: int):
    """Every (R, S) points_plan can pick at this tile and K: R the
    kBlockPixels rows or a halving of them (to two warps of pixels at
    least, while blocks are fewer than SMs), S a power of two up to
    kMaxGroups with S * R * tile <= 1024 whose lists fit in shared memory
    (1 where R * tile is not whole warps); which of them a launch takes
    depends on the card's occupancy."""
    rows = [min(tile, max(1, BLOCK_PIXELS // tile))]
    while rows[-1] % 2 == 0 and (rows[-1] // 2) * tile % 64 == 0:
        rows.append(rows[-1] // 2)
    out = []
    for R in rows:
        S, np_ = 1, R * tile
        out.append((R, 1))
        while (np_ % 32 == 0 and 2 * S <= MAX_GROUPS
               and 2 * S * np_ <= MAX_THREADS
               and smem(2 * S * np_, K) <= MAX_SMEM):
            S *= 2
            out.append((R, S))
    return out


def splat_boxes(x, y, rr):
    """Cull boxes (..., 4) = x0, x1, y0, y1 of staged candidates whose
    r^2 is rr (-1 at or behind znear), copied from ``splat_box`` in
    csrc/points_select.cu (the source, where the margin is argued): half
    width 1.001 sqrt(rr) + 1e-6 (|x| + |y| + 1); an empty box (kInf, -kInf)
    where rr < 0 or NaN."""
    h = (1.001 * torch.sqrt(rr.clamp_min(0.0))
         + 1e-6 * (x.abs() + y.abs() + 1.0))
    box = torch.stack([x - h, x + h, y - h, y + h], dim=-1)
    empty = torch.tensor([INF, -INF, INF, -INF], dtype=box.dtype)
    return torch.where((rr >= 0.0)[..., None], box, empty)


def warp_spans(px, py, tile: int, R: int, S: int):
    """(B, A, S, tile^2, 4) x0, x1, y0, y1: the least and greatest pixel
    coordinates of the warp that holds (group g, pixel p), as the kernel
    reduces them over its lanes. Threads are (column, row, group) in blocks
    of R rows; a block's rows past the tile take the last row's pixels."""
    B, A, tp = px.shape
    n = S * R * tile
    t = torch.arange(n)
    col, r_in, grp = t % tile, (t // tile) % R, t // (tile * R)
    out = torch.zeros((B, A, S, tp, 4))
    for blk in range(-(-tile // R)):
        row = blk * R + r_in
        pix = row.clamp(max=tile - 1) * tile + col
        for w0 in range(0, n, 32):
            w = slice(w0, min(w0 + 32, n))
            g = grp[w]
            assert bool((g == g[0]).all()), "a warp spans two groups"
            span = torch.stack([px[..., pix[w]].amin(-1),
                                px[..., pix[w]].amax(-1),
                                py[..., pix[w]].amin(-1),
                                py[..., pix[w]].amax(-1)], dim=-1)
            own = row[w] < tile
            out[:, :, int(g[0]), pix[w][own]] = span[:, :, None, :]
    return out


def split_points_model(slab, count, origin, offs, K, znear, r2, R, S):
    """Winner slots (B, A, K, tile^2) through the kernel's decomposition
    with blocks of R rows and S groups per pixel; also returns the number
    of (pixel, slot) pairs the cull skipped. Raises if the cull skips a
    pair that covers."""
    tp = offs.shape[0]
    tile = math.isqrt(tp)
    prio = cuda_points._priority(slab, count, origin, offs, znear,
                                 r2)                         # (B, A, tp, P)
    P = prio.shape[-1]
    x, y, z = (slab[:, :, :P, c] for c in range(3))
    rr = slab[:, :, :P, 3] if r2 is None else torch.full_like(
        x, float(np.float32(r2)))
    rr = torch.where(z > znear, rr, torch.full_like(rr, -1.0))
    box = splat_boxes(x, y, rr)                              # (B, A, P, 4)
    px = offs[:, 0] + origin[..., 0:1]                       # (B, A, tp)
    py = offs[:, 1] + origin[..., 1:2]
    span = warp_spans(px, py, tile, R, S)                    # (B, A, S, tp, 4)
    slots = torch.arange(P)
    # only covering pairs can enter a list: each pixel's covering slots,
    # in ascending slot order, first (the lists see nothing else)
    cover = prio < INF
    nc = max(1, int(cover.sum(-1).max()))
    order = torch.argsort((~cover).to(torch.int8), dim=-1,
                          stable=True)[..., :nc]             # (B, A, tp, nc)
    zc = prio.gather(-1, order)
    lists, skipped = [], 0
    for g in range(S):
        sx0, sx1, sy0, sy1 = (span[:, :, g, :, i, None] for i in range(4))
        bx0, bx1, by0, by1 = (box[:, :, None, :, i] for i in range(4))
        miss = (sx1 < bx0) | (sx0 > bx1) | (sy1 < by0) | (sy0 > by1)
        mine = (slots % CHUNK) % S == g
        cull = miss & mine
        if bool(cover[cull].any()):
            raise AssertionError("the cull skipped a covering pair")
        skipped += int(cull.sum())
        keep = (mine & ~cull).gather(-1, order)
        zg = torch.where(keep, zc, torch.full_like(zc, INF))
        lists.append(_lex_topk(zg, order, K))
    half = S // 2
    while half:
        lists = [_lex_topk(torch.cat([lists[g][0], lists[g + half][0]], -1),
                           torch.cat([lists[g][1], lists[g + half][1]], -1),
                           K) for g in range(half)]
        half //= 2
    lane = lists[0][1]                                       # (B, A, tp, K)
    return lane.transpose(2, 3).to(torch.int32).contiguous(), skipped


def point_slabs(seed, B, A, P, tile, per_point):
    """Candidate slabs (B, A, P, 4 | 5) (x, y, z, [r^2,] slot id), counts,
    origins, offsets and the uniform r^2 (None per point). Pixel
    coordinates are multiples of 1/16; a share of the splats sit on pixel
    centres, a share exactly one rim away (x = px + 3/64, y = py, r^2 =
    9/4096: d^2 == r^2 exactly), some at z = znear or behind it, and
    later slots copy earlier ones (ties). Tile (0, 0) is full (P > 256
    fills two staging chunks) and the last tile empty."""
    rng = np.random.default_rng(seed)
    offs = tile_pixel_coords((32, 32), tile)
    tp = tile * tile
    span = tile / 16
    r2u = 9.0 / 4096
    origin = rng.integers(-tile, tile, size=(B, A, 2)) / 16.0
    kind = rng.integers(0, 5, size=(B, A, P))
    xy = rng.uniform(-0.2 * span, 1.2 * span, size=(B, A, P, 2))
    pix = offs.numpy()[rng.integers(0, tp, size=(B, A, P))]
    centre = pix + origin[:, :, None]
    rim = centre + np.array([3.0 / 64, 0.0])
    xy = np.where(kind[..., None] == 1, centre, xy + origin[:, :, None])
    xy = np.where(kind[..., None] == 2, rim, xy)
    z = rng.choice(np.linspace(1.0, 3.0, 9), size=(B, A, P))
    z = np.where(rng.uniform(size=(B, A, P)) < 0.05, ZNEAR, z)
    z = np.where(rng.uniform(size=(B, A, P)) < 0.05, -0.5, z)
    cols = [xy[..., 0], xy[..., 1], z]
    if per_point:
        r2 = rng.uniform(0.0, (0.25 * span) ** 2, size=(B, A, P))
        cols.append(np.where(kind == 2, r2u, r2))
    cols.append(np.broadcast_to(np.arange(P, dtype=np.float64), (B, A, P)))
    slab = np.stack(cols, axis=-1)
    dup = kind == 3                                 # copy an earlier slot
    src = (rng.uniform(size=(B, A, P)) * np.arange(P)).astype(np.int64)
    slab = np.where(dup[..., None],
                    np.take_along_axis(slab, src[..., None], axis=2), slab)
    count = rng.integers(0, P + 1, size=(B, A))
    count[0, 0] = P
    count[-1, -1] = 0
    f32 = torch.float32
    return (torch.tensor(slab, dtype=f32),
            torch.tensor(count, dtype=torch.int32),
            torch.tensor(origin, dtype=f32), offs,
            None if per_point else r2u)


@pytest.mark.parametrize("per_point", [False, True])
@pytest.mark.parametrize("K", [1, 4, 8, 64])
@pytest.mark.parametrize("tile", [8, 16, 32])
def test_split_model_equals_plain(tile, K, per_point):
    slab, count, origin, offs, r2 = point_slabs(tile + K, 1, 3, 300, tile,
                                                per_point)
    ref = cuda_points.points_select_reference(slab, count, origin, offs, K,
                                              ZNEAR, r2)
    assert bool((ref[0, -1] == -1).all())                # the empty tile
    assert bool((ref[0, :2] >= 0).any())
    for R, S in plans(tile, K):
        lane, skipped = split_points_model(slab, count, origin, offs, K,
                                           ZNEAR, r2, R, S)
        assert torch.equal(lane, ref), (R, S)
        assert skipped > 0


def test_slabs_hold_rims_and_znear():
    """The seeded slabs do reach the cases the model is held on: pixels
    exactly on a rim that count as covered, and candidates at or behind
    znear that never win."""
    slab, count, origin, offs, r2 = point_slabs(24, 1, 3, 300, 16, False)
    px = offs[:, 0] + origin[..., 0:1]
    py = offs[:, 1] + origin[..., 1:2]
    dx = px[..., None] - slab[:, :, None, :, 0]
    dy = py[..., None] - slab[:, :, None, :, 1]
    d2 = dx * dx + dy * dy                                  # (B, A, tp, P)
    live = torch.arange(300) < count[..., None, None].long()
    on_rim = (d2 == np.float32(r2)) & live & (slab[:, :, None, :, 2] > ZNEAR)
    assert int(on_rim.sum()) > 0
    lane = cuda_points.points_select_reference(slab, count, origin, offs, 64,
                                               ZNEAR, r2)
    live = torch.arange(300) < count[..., None].long()
    assert int(((slab[..., 2] <= ZNEAR) & live).sum()) > 0
    won = slab[..., 2].gather(2, lane.clamp_min(0).long().flatten(2))
    assert bool((won.reshape(lane.shape)[lane >= 0] > ZNEAR).all())


def test_split_model_on_binned_cloud():
    """A small cloud binned at tile 16 as the binned raster bins it (64^2,
    2000 points, radius 0.05, K = 8), uniform and per-point radii."""
    from torch_renderer_tpu_torch.cameras.perspective import (
        PerspectiveCamera,
    )
    from torch_renderer_tpu_torch.rasterize.points import (
        PointsRasterizationSettings,
        project_points_screen,
    )
    from torch_renderer_tpu_torch.structures.pointclouds import Pointclouds

    rng = np.random.default_rng(7)
    pts = rng.normal(0.0, 0.4, (1, 2000, 3)).astype(np.float32)
    pts[..., 2] += 2.5
    K = np.array([[51.2, 0, 32], [0, 51.2, 32], [0, 0, 1]], np.float32)
    cam = PerspectiveCamera.from_K(K, (64, 64), device="cpu")
    cloud = Pointclouds.from_padded(pts, device="cpu")
    st = PointsRasterizationSettings((64, 64), radius=0.05,
                                     points_per_pixel=8, bin_size=16,
                                     max_points_per_bin=1000,
                                     check_budgets="off")
    q, z, valid = project_points_screen(cloud, cam, st.znear)
    r2 = torch.full_like(z, 0.05 ** 2)
    radii = torch.tensor(rng.uniform(0.02, 0.08, z.shape), dtype=torch.float32)
    for inp in (cuda_points.binned_point_inputs(q, z, valid, r2, st,
                                                uniform_r2=0.05 ** 2),
                cuda_points.binned_point_inputs(q, z, valid, radii ** 2, st)):
        args = (inp.slab, inp.count, inp.origin, inp.offs, 8, st.znear,
                inp.r2)
        ref = cuda_points.points_select_reference(*args)
        assert bool((ref >= 0).any())
        for R, S in plans(16, 8):
            lane, skipped = split_points_model(*args, R, S)
            assert torch.equal(lane, ref), (R, S)
            assert skipped > 0

"""A CPU model of the top-K kernel's decomposition (csrc/hard_raster.cu
``topk_select_kernel``) against its plain version.

The kernel gives each pixel S thread groups (the largest power of two with
S * tile^2 <= 1024 whose lists of K entries fit in shared memory beside
the staging buffer; see ``groups``), hands group s the entries s,
s + S, ... of each 256-slot chunk, lets a warp skip a face whose cull box
(``cull_boxes``, a copy of the kernel's ``cull_box``) lies wholly above,
below, left or right of the warp's pixel span, and merges the
groups' sorted lists in (depth, slot) order. The model does the same in
plain torch on the plain version's priorities and must give exactly the
plain version's winners (``topk_select_reference``), on seeded random slabs
that hold faces with corners and edges on pixel centres, faces smaller than
a pixel, slivers, duplicated faces (ties), more than 128 candidates and an
empty tile, and on the pose-fit scene at 64^2. It also checks the cull's
claim directly: every pair it skips has priority INF. That proves the
Python copy of the margin safe; the card tests
(tests/test_torch_cuda_kernels.py) hold the kernel's own copy to the plain
version on the same ``topk_slabs``. No JAX here.
"""

import math

import numpy as np
import pytest
import torch

from torch_renderer_tpu_torch.rasterize import cuda_hard

CHUNK = 256          # the kernel's candidates per shared-memory pass
STAGE_BYTES = CHUNK * (16 + 5 * 16)  # its staged cull boxes and faces
MAX_SMEM = 232448    # the shared memory a block may opt into
INV_S = 1.0 / 16


def topk_slabs(seed, B, A, F, tile, inv_s=INV_S):
    """Candidate slabs (B, A, F, 13), counts and origins of tiles shifted
    by whole pixels, faces placed around their tile (pixel centres and the
    on-centre corners sit on multiples of inv_s): a mix of large random faces, faces with every
    corner on a pixel centre, faces smaller than a pixel, slivers and
    collinear faces, and copies of earlier faces at later slots (equal
    depth: ties). Face ids ascend with the slot. Tile (0, 0) is full, the
    last tile empty, and F > 128 fills more than one staging chunk."""
    rng = np.random.default_rng(seed)
    span = tile * inv_s
    kind = rng.integers(0, 5, size=(B, A, F))
    q = rng.uniform(-0.3 * span, 1.3 * span, size=(B, A, F, 6))
    on_px = rng.integers(-2, tile + 2, size=(B, A, F, 6)) * inv_s
    centre = rng.integers(0, tile, size=(B, A, F, 1, 2)) * inv_s
    tiny = (centre + rng.uniform(-0.6, 0.6, size=(B, A, F, 3, 2)) * inv_s
            ).reshape(B, A, F, 6)
    a = rng.uniform(-0.3 * span, 1.3 * span, size=(B, A, F, 1, 2))
    d = rng.normal(size=(B, A, F, 1, 2))
    s = np.stack([np.zeros((B, A, F)), rng.uniform(0.2, 1.0, (B, A, F)),
                  rng.uniform(0.0, 1.0, (B, A, F))], axis=-1)[..., None]
    bend = rng.normal(size=(B, A, F, 1, 2)) * 10.0 ** rng.uniform(
        -8, -2, size=(B, A, F, 1, 1)) * span
    sliver = a + s * d * span + np.concatenate(
        [np.zeros((B, A, F, 2, 2)), bend], axis=3)
    sliver = sliver.reshape(B, A, F, 6)
    q = np.where(kind[..., None] == 1, on_px, q)
    q = np.where(kind[..., None] == 2, tiny, q)
    q = np.where(kind[..., None] == 3, sliver, q)
    z = rng.uniform(1.0, 3.0, size=(B, A, F, 3))
    z = np.where(kind[..., None] == 1, 2.0, z)   # equal-depth planes: ties
    slab = np.concatenate([q, z, 1.0 / z, np.zeros((B, A, F, 1))], axis=-1)
    dup = kind == 4                                # copy an earlier slot
    src = (rng.uniform(size=(B, A, F)) * np.arange(F)).astype(np.int64)
    slab = np.where(dup[..., None],
                    np.take_along_axis(slab, src[..., None], axis=2), slab)
    slab[..., 12] = np.sort(rng.choice(4 * F, size=(B, A, F)), axis=-1)
    count = rng.integers(0, F + 1, size=(B, A))
    count[0, 0] = F
    count[-1, -1] = 0
    origin = rng.integers(-tile, tile, size=(B, A, 2)) * inv_s
    slab[..., 0:6] += np.tile(origin[:, :, None], (1, 1, 1, 3))
    f32 = torch.float32
    return (torch.tensor(slab, dtype=f32),
            torch.tensor(count, dtype=torch.int32),
            torch.tensor(origin, dtype=f32))


def cull_boxes(slab, blur: float) -> torch.Tensor:
    """Cull boxes (..., F, 4) = x0, x1, y0, y1 of slab rows (..., F, 13):
    each face's screen bounding box grown by the margin past which no pixel
    can be covered, copied from ``cull_box`` in csrc/hard_raster.cu (the
    source, where the margin is argued): with eps = 2^-24, L the longest
    edge, A = |area2| and C the largest |corner coordinate|,
    M = 1.001 (1.002 sqrt(blur) + 4e-3 L + 40 eps L^3 / A) + 4 eps C, and
    M = inf (no cull) where A <= 4e-12 or A < 64 eps L^2. The kernels skip
    a face for a warp whose pixel span the box misses."""
    eps = 2.0 ** -24
    qx, qy = slab[..., 0:6:2], slab[..., 1:6:2]
    len2 = [((qx[..., b] - qx[..., a]) ** 2 + (qy[..., b] - qy[..., a]) ** 2)
            .clamp_min(1e-12) for a, b in ((0, 1), (1, 2), (2, 0))]
    L2 = torch.maximum(torch.maximum(len2[0], len2[1]), len2[2])
    L = torch.sqrt(L2)
    area = ((qx[..., 1] - qx[..., 0]) * (qy[..., 2] - qy[..., 0])
            - (qy[..., 1] - qy[..., 0]) * (qx[..., 2] - qx[..., 0])).abs()
    C = torch.maximum(qx.abs().amax(-1), qy.abs().amax(-1))
    margin = (1.001 * (math.sqrt(max(blur, 0.0)) * 1.002 + 4e-3 * L
                       + 40.0 * eps * L * L2 / area) + 4.0 * eps * C)
    ok = (area > 4e-12) & (area >= 64.0 * eps * L2)
    margin = torch.where(ok, margin, torch.full_like(margin, math.inf))
    return torch.stack([qx.amin(-1) - margin, qx.amax(-1) + margin,
                        qy.amin(-1) - margin, qy.amax(-1) + margin], dim=-1)


def groups(K: int, tile: int) -> int:
    """S, the kernel's thread groups per pixel: each thread keeps a list of
    K (depth, slot) entries of 8 bytes in shared memory. Where even one
    group's lists do not fit (tile 32 with K > 25), S is 1 and the kernel
    splits the tile's pixels among 2 or 4 blocks; their warps hold the same
    rows as one block's would (whole rows of 32 pixels), so the model does
    not split."""
    tp = tile * tile
    S = 1
    while (2 * S * tp <= 1024
           and STAGE_BYTES + 2 * S * tp * K * 8 <= MAX_SMEM):
        S *= 2
    return S


def warp_spans(tile: int, S: int) -> torch.Tensor:
    """(S * tile^2, 4) int: each thread's warp's first and last column and
    row (c_lo, c_hi, r_lo, r_hi), as the kernel takes them: its rows, and
    its columns where it holds part of one row; the whole tile for a warp
    that spans two groups."""
    tp = tile * tile
    n = S * tp
    spans = torch.zeros((n, 4), dtype=torch.int64)
    for t in range(n):
        t0 = t & ~31
        t1 = min(t0 + 31, n - 1)
        c_lo, c_hi, r_lo, r_hi = 0, tile - 1, 0, tile - 1
        if t0 // tp == t1 // tp:
            p0, p1 = t0 % tp, t1 % tp
            r_lo, r_hi = p0 // tile, p1 // tile
            if r_lo == r_hi:
                c_lo, c_hi = p0 % tile, p1 % tile
        spans[t] = torch.tensor([c_lo, c_hi, r_lo, r_hi])
    return spans


def span_misses(box, origin, spans, inv_s: float) -> torch.Tensor:
    """(B, A, n, F) bool: the box (B, A, F, 4) lies wholly to one side of
    the warp's pixel span (spans (n, 4), pixel coordinates origin + index *
    inv_s, as the kernel's grid_at); false for a NaN box."""
    c = spans.to(torch.float32) * inv_s                      # (n, 4)
    x = origin[..., None, 0:1] + c[:, 0:2]                   # (B, A, n, 2)
    y = origin[..., None, 1:2] + c[:, 2:4]
    x0, x1, y0, y1 = (box[..., None, :, i] for i in range(4))  # (B, A, 1, F)
    return ((y[..., 1:2] < y0) | (y[..., 0:1] > y1)
            | (x[..., 1:2] < x0) | (x[..., 0:1] > x1))


def _lex_topk(z, slot, K: int):
    """The first K entries of each row in (z, slot) order; slot -1 where
    z is INF."""
    slot, order = torch.sort(slot, dim=-1, stable=True)
    z = z.gather(-1, order)
    z, order = torch.sort(z, dim=-1, stable=True)
    slot = slot.gather(-1, order)
    z, slot = z[..., :K], slot[..., :K]
    if z.shape[-1] < K:
        pad = K - z.shape[-1]
        z = torch.nn.functional.pad(z, (0, pad), value=cuda_hard.INF)
        slot = torch.nn.functional.pad(slot, (0, pad), value=-1)
    return z, torch.where(z < cuda_hard.INF, slot, torch.full_like(slot, -1))


def split_topk_model(slab, count, origin, K, tile, inv_s, blur, znear):
    """Winner slots (B, A, K, tile^2) through the kernel's decomposition;
    also returns the number of (pixel, slot) pairs the cull skipped.
    Raises if the cull skips a pair whose priority is not INF."""
    tp = tile * tile
    S = groups(K, tile)
    prio = cuda_hard._priority(slab, count, origin, tile, inv_s, blur,
                               znear)                        # (B, A, P, F)
    F = prio.shape[-1]
    box = cull_boxes(slab[:, :, :F], blur)         # (B, A, F, 4)
    spans = warp_spans(tile, S)
    slots = torch.arange(F)
    lists, skipped = [], 0
    for g in range(S):
        miss = span_misses(box, origin, spans[g * tp:(g + 1) * tp], inv_s)
        mine = (slots % CHUNK) % S == g
        cull = miss & mine
        if bool((prio[cull] < cuda_hard.INF).any()):
            raise AssertionError("the cull skipped a covering pair")
        skipped += int(cull.sum())
        z = torch.where(mine & ~cull, prio, torch.full_like(prio,
                                                            cuda_hard.INF))
        lists.append(_lex_topk(z, slots.expand_as(z), K))
    half = S // 2
    while half:
        lists = [_lex_topk(torch.cat([lists[g][0], lists[g + half][0]], -1),
                           torch.cat([lists[g][1], lists[g + half][1]], -1),
                           K) for g in range(half)]
        half //= 2
    lane = lists[0][1]                                       # (B, A, P, K)
    return lane.transpose(2, 3).to(torch.int32).contiguous(), skipped


@pytest.mark.parametrize("blur", [0.0, 9.21e-4])
@pytest.mark.parametrize("K", [1, 4, 8, 16, 32, 50, 64])
@pytest.mark.parametrize("tile", [8, 16, 32])
def test_split_model_equals_plain(tile, K, blur):
    slab, count, origin = topk_slabs(tile + K, 1, 3, 150, tile)
    args = (slab, count, origin, K, tile, INV_S, blur, 1e-5)
    lane, skipped = split_topk_model(*args)
    ref = cuda_hard.topk_select_reference(*args)
    assert torch.equal(lane, ref)
    assert skipped > 0
    assert bool((ref[0, -1] == -1).all())        # the empty tile


@pytest.mark.parametrize("K,blur", [(4, math.log(1.0 / 1e-4 - 1.0) * 1e-4),
                                    (50, 1e-4)])
def test_split_model_on_pose_scene(K, blur):
    """The pose fit's scene at 64^2 (level-3 icosphere in the unit sphere,
    look_at(2.7, 15, 40)), binned at tile 16 as the raster bins it."""
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

    size = (64, 64)
    meshes = Meshes.from_single(*icosphere(3), device="cpu")
    meshes, _, _ = meshes.center_and_scale_to_unit_sphere()
    R, t = look_at_view_transform(2.7, 15.0, 40.0)
    cam = PerspectiveCamera.from_K(pinhole_K(size), size, R=R[0].numpy(),
                                   t=t[0].numpy(), device="cpu")
    st = autotune.resolve_mesh_settings(
        RasterizationSettings(size, blur_radius=blur, faces_per_pixel=K,
                              bin_size=16, check_budgets="off"),
        meshes, cam, margin=2.0)
    inp = cuda_hard.binned_inputs(setup_face_planes(meshes, cam), st)
    args = (inp.slab, inp.count, inp.origin, K, st.bin_size, inp.inv_s,
            blur, st.znear)
    lane, skipped = split_topk_model(*args)
    ref = cuda_hard.topk_select_reference(*args)
    assert torch.equal(lane, ref)
    assert bool((ref >= 0).any()) and skipped > 0

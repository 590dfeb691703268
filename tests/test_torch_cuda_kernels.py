"""The hand-written CUDA kernels (soft coverage, hard raster, bilinear
texture sampling, point selection, tile gather, untile) against their plain
PyTorch versions,
on an NVIDIA GPU. Marked ``cuda``: without a card every test here skips
(the decision is made in a fixture, never at import).

Tolerances: soft forward sums within 1e-4 + 1e-5 * max|S| (float32 sums in
another order); soft backward within 1e-3 of max|dq| (another order and
form of the pixel sums), at tiles of 10^4 pixels plus what a slot's
flipped edge ties can move (_tie_flips; at most 1% of the live slots, and
within 1e-3 alone with the cotangent 0 at those pixels). Hard winners equal, or differing only at
selection-depth ties within 1e-6 on under 0.1% of pixels; hard values within
1e-5 where the winners agree (the kernels repeat the plain arithmetic op
for op, so they are expected to be equal). Texture sampling: the forward
within 1e-6 (the same operations, so expected equal); d_wy and d_wx within
1e-5 of their largest (a channel sum in another order); d_maps within 1e-5
of its largest (float32 atomics add a texel's terms in an order that
changes from run to run), at uniform, clustered and every-alignment
corners. Point selection: winners equal (the kernel
repeats the plain coverage arithmetic op for op); end to end on the card
against the CPU, point ids differ on under 0.1% of pixels (the projection
rounds otherwise on the card, which can move a splat's rim) and values
agree within 1e-6 where they are the same. Tile gather: the forward equal
(a copy); the backward within 1e-6 of the largest table gradient (float32
atomics add a row's terms in an order that changes from run to run).
Untile: equal (a copy of 4- or 8-byte words), for float32 and int64 fields,
strided rows, several fields in one launch and the renderer's fragments.
The soft forward also equals its CPU model (tests/test_torch_soft_fwd.py)
bit for bit. The sharded paths (parallel/, ``-k sharded``) run on two
ranks (NCCL on two cards, or gloo with both on cuda:0) through
tests/torch_parallel_cases.py: each kernel launched once a call on every
rank, α within 2e-4 and the gradient within 1e-3 of its largest against
one rank, ICP within 1e-5, points within 1e-5, the COCO outputs equal.
"""

import numpy as np
import pytest
import torch

from torch_renderer_tpu_torch.rasterize import cuda_soft
from torch_renderer_tpu_torch.utils import timing

pytestmark = pytest.mark.cuda


def _launches(*names) -> tuple:
    """The wrappers' launch counters (utils.timing), in order."""
    counts = timing.counters()
    return tuple(counts[n] for n in names)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _slabs(seed, B, A, K, tile, device, inv_s=1.0 / 16):
    rng = np.random.default_rng(seed)
    span = tile * inv_s
    q = rng.uniform(-0.3 * span, 1.3 * span, size=(B, A, K, 6))
    count = rng.integers(0, K + 1, size=(B, A))
    count[0, 0] = K          # one full tile
    count[-1, -1] = 0        # one empty tile
    return (torch.tensor(q, dtype=torch.float32, device=device),
            torch.tensor(count, dtype=torch.int32, device=device))


# K=300 and K=150 stream several shared-memory chunks (counts above 128);
# counts are random, so mostly not multiples of the backward's 8 warps;
# tiles 8, 16 and 32 give its lanes 2, 8 and 32 pixels each, tile 4 leaves
# half of each warp's lanes idle; tile=32 is the forward's 1024-thread
# maximum.
# _slabs makes tile (0, 0) full and the last tile empty.
@pytest.mark.parametrize("B,A,K,tile,sigma", [
    (2, 3, 5, 4, 1e-3), (2, 7, 64, 8, 1e-4), (1, 5, 300, 16, 1e-4),
    (3, 2, 40, 32, 1e-4), (2, 4, 13, 16, 1e-4), (2, 3, 150, 8, 1e-3),
    (1, 3, 150, 32, 1e-4),
])
def test_kernels_match_plain(device, B, A, K, tile, sigma):
    q, count = _slabs(0, B, A, K, tile, device)
    inv_s, inv_sigma = 1.0 / 16, 1.0 / sigma
    g = torch.rand((B, A, tile * tile), device=device)
    before = _launches("soft_coverage_fwd", "soft_coverage_bwd")
    S = cuda_soft.soft_coverage_fwd(q, count, tile, inv_s, inv_sigma)
    dq = cuda_soft.soft_coverage_bwd(q, count, g, tile, inv_s, inv_sigma)
    torch.cuda.synchronize()
    assert _launches("soft_coverage_fwd", "soft_coverage_bwd") == \
        (before[0] + 1, before[1] + 1)
    S_ref = cuda_soft.soft_coverage_fwd_reference(q, count, tile, inv_s,
                                                  inv_sigma)
    dq_ref = cuda_soft.soft_coverage_bwd_reference(q, count, g, tile, inv_s,
                                                   inv_sigma)
    torch.testing.assert_close(S, S_ref, rtol=0,
                               atol=1e-4 + 1e-5 * float(S_ref.abs().max()))
    torch.testing.assert_close(dq, dq_ref, rtol=0,
                               atol=1e-3 * float(dq_ref.abs().max()))
    assert (S[-1, -1] == 0).all() and (dq[-1, -1] == 0).all()
    dead = torch.arange(K, device=device) >= count[..., None]   # (B, A, K)
    assert bool((dq[dead] == 0).all())


# The forward at the staging chunk's boundaries (counts 0, 1, 127, 128,
# 129 and 300 of a 300-slot slab, one tile each) for tiles 8, 16 and 32
# and sigma 1e-5, 1e-4 and 1e-3 (the cull margin and the cutoff scale with
# sqrt(sigma)).
@pytest.mark.parametrize("sigma", [1e-5, 1e-4, 1e-3])
@pytest.mark.parametrize("tile", [8, 16, 32])
def test_soft_fwd_chunk_counts(device, tile, sigma):
    q, _ = _slabs(tile, 2, 6, 300, tile, device)
    count = torch.tensor([[0, 1, 127, 128, 129, 300]] * 2, dtype=torch.int32,
                         device=device)
    before = timing.counters()["soft_coverage_fwd"]
    S = cuda_soft.soft_coverage_fwd(q, count, tile, 1.0 / 16, 1.0 / sigma)
    torch.cuda.synchronize()
    assert timing.counters()["soft_coverage_fwd"] == before + 1
    ref = cuda_soft.soft_coverage_fwd_reference(q, count, tile, 1.0 / 16,
                                                1.0 / sigma)
    torch.testing.assert_close(S, ref, rtol=0,
                               atol=1e-4 + 1e-5 * float(ref.abs().max()))
    assert bool((S[:, 0] == 0).all())


# The kernel's float32 operations are all written out, so it equals the
# CPU model of tests/test_torch_soft_fwd.py bit for bit (the model's FMA
# rounds once through float64, as the card's does), cull and skip included.
@pytest.mark.parametrize("tile,K,sigma", [(8, 64, 1e-4), (16, 130, 1e-4),
                                          (32, 40, 1e-5), (25, 20, 1e-3)])
def test_soft_fwd_matches_cpu_model(device, tile, K, sigma):
    from test_torch_soft_fwd import fwd_model, random_slabs

    q, count = random_slabs(tile + K, 2, 3, K, tile)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    S_model, _, _ = fwd_model(q, count, tile, 1.0 / 16, 1.0 / sigma, sms)
    S = cuda_soft.soft_coverage_fwd(q.to(device), count.to(device), tile,
                                    1.0 / 16, 1.0 / sigma)
    assert torch.equal(S.cpu(), S_model)


def test_fused_path_matches_cpu(device):
    """soft_silhouette_fd and its vertex gradient on the card against the
    same call on the CPU (plain versions)."""
    import torch_renderer_tpu_torch as trt

    verts, faces = trt.icosphere(2)
    f = 0.8 * 64
    K = np.array([[f, 0, 32], [0, f, 32], [0, 0, 1]], np.float32)
    t = np.array([[0.0, 0.0, 3.0], [0.2, -0.1, 2.5]], np.float32)
    out = {}
    for dev in ("cpu", device):
        meshes = trt.Meshes.from_single(verts, faces, device=dev).extend(2)
        cam = trt.PerspectiveCamera.from_K(K, (64, 64), t=t, device=dev)
        v = meshes.verts.clone().requires_grad_(True)
        fp = trt.setup_face_planes(meshes.update_padded(v), cam)
        cfg = trt.suggest_soft_config(fp, (64, 64), layout="packed")
        alpha = trt.soft_silhouette_fd(fp, (64, 64), **cfg.kwargs())
        alpha.sum().backward()
        out[str(dev)] = (alpha.detach().cpu(), v.grad.cpu())
    (a_cpu, g_cpu), (a_gpu, g_gpu) = out["cpu"], out[str(device)]
    torch.testing.assert_close(a_gpu, a_cpu, rtol=0, atol=1e-4)
    torch.testing.assert_close(g_gpu, g_cpu, rtol=0,
                               atol=1e-3 * float(g_cpu.abs().max()))


def test_wrapper_rejects_strided_input(device):
    q, count = _slabs(1, 2, 3, 8, 8, device)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_soft.soft_coverage_fwd(q.transpose(0, 1), count.t(), 8,
                                    1.0 / 16, 1e4)


def _split_scene(dev):
    """The split parity tests' second scene (tests/test_torch_occupancy_
    split.py): 320 faces at 128^2, where suggest_soft_config sizes a
    split."""
    import torch_renderer_tpu_torch as trt

    verts, faces = trt.icosphere(2)
    f = 0.8 * 128
    K = np.array([[f, 0, 64], [0, f, 64], [0, 0, 1]], np.float32)
    t = np.array([[0.0, 0.0, 3.0], [0.3, 0.2, 3.4]], np.float32)
    meshes = trt.Meshes.from_single(verts, faces, device=dev).extend(2)
    cam = trt.PerspectiveCamera.from_K(K, (128, 128), t=t, device=dev)
    return meshes, cam


def _soft_and_grad(meshes, cam, **kw):
    import torch_renderer_tpu_torch as trt

    v = meshes.verts.clone().requires_grad_(True)
    fp = trt.setup_face_planes(meshes.update_padded(v), cam)
    alpha = trt.soft_silhouette_fd(fp, cam.image_size, **kw)
    alpha.sum().backward()
    return alpha.detach(), v.grad


@pytest.mark.parametrize("lo", [None, 6])
def test_split_route_matches_cpu(device, lo):
    """soft_silhouette_fd under the occupancy split on the card against the
    same call on the CPU (plain versions): the sized split, and lo_lanes 6,
    under which tail tiles drop candidates."""
    import torch_renderer_tpu_torch as trt

    out = {}
    for dev in ("cpu", device):
        meshes, cam = _split_scene(dev)
        with torch.no_grad():
            fp = trt.setup_face_planes(meshes, cam)
        cfg = trt.suggest_soft_config(fp, cam.image_size, split=True)
        assert cfg.hi_tiles is not None
        if lo is not None:
            cfg = cfg._replace(lo_lanes=lo)
        out[str(dev)] = _soft_and_grad(meshes, cam, **cfg.kwargs())
    (a_cpu, g_cpu), (a_gpu, g_gpu) = out["cpu"], out[str(device)]
    torch.testing.assert_close(a_gpu.cpu(), a_cpu, rtol=0, atol=1e-4)
    torch.testing.assert_close(g_gpu.cpu(), g_cpu, rtol=0,
                               atol=1e-3 * float(g_cpu.abs().max()))


def test_forced_split_equals_unsplit(device):
    """A split with lo_lanes = faces_per_tile drops nothing: alpha within
    1e-6 of the unsplit route's (each tile sums the same slots), vertex
    gradients within 1e-5 of their largest (float32 atomics of the gather
    backward add in another order), and the same kernels launched as
    often."""
    import torch_renderer_tpu_torch as trt

    meshes, cam = _split_scene(device)
    with torch.no_grad():
        fp = trt.setup_face_planes(meshes, cam)
    cfg = trt.suggest_soft_config(fp, cam.image_size, layout="packed")
    runs = []
    for hi in (None, 8):
        kw = cfg._replace(hi_tiles=hi, lo_lanes=cfg.faces_per_tile).kwargs()
        before = _launches("soft_coverage_fwd", "soft_coverage_bwd",
                           "gather_tiles_fwd", "gather_tiles_bwd")
        a, g = _soft_and_grad(meshes, cam, **kw)
        torch.cuda.synchronize()
        after = _launches("soft_coverage_fwd", "soft_coverage_bwd",
                          "gather_tiles_fwd", "gather_tiles_bwd")
        runs.append((a, g, tuple(x - y for x, y in zip(after, before))))
    (a0, g0, n0), (a1, g1, n1) = runs
    assert n0 == n1 == (1, 1, 1, 1)
    torch.testing.assert_close(a1, a0, rtol=0, atol=1e-6)
    torch.testing.assert_close(g1, g0, rtol=0,
                               atol=1e-5 * float(g0.abs().max()))


# ---------------------------------------------------------------------------
# Hard-raster kernels (csrc/hard_raster.cu)
# ---------------------------------------------------------------------------

def _hard_slabs(seed, B, A, F, tile, device, inv_s=1.0 / 16):
    """Random candidate slabs over tiles at origin (0, 0) + a random shift:
    corners spread past the tile, z in [1, 3], invz = 1 / z, face ids in
    ascending slot order; one full tile and one empty tile."""
    rng = np.random.default_rng(seed)
    span = tile * inv_s
    q = rng.uniform(-0.3 * span, 1.3 * span, size=(B, A, F, 6))
    z = rng.uniform(1.0, 3.0, size=(B, A, F, 3))
    fid = np.sort(rng.choice(4 * F, size=(B, A, F)), axis=-1)
    slab = np.concatenate([q, z, 1.0 / z, fid[..., None]], axis=-1)
    count = rng.integers(0, F + 1, size=(B, A))
    count[0, 0] = F
    count[-1, -1] = 0
    origin = rng.uniform(-1.0, 1.0, size=(B, A, 2))
    as_t = lambda a, dt: torch.tensor(a, dtype=dt, device=device)  # noqa
    return (as_t(slab, torch.float32), as_t(count, torch.int32),
            as_t(origin, torch.float32))


def _equal_or_ties(lane_k, lane_p, prio):
    """Winner slots (B, A, K, P) agree, or differ only at selection-depth
    ties within 1e-6 (float32 rounding of equal depths)."""
    diff = (lane_k != lane_p).transpose(2, 3)
    if not bool(diff.any()):
        return
    z = lambda lane: prio.gather(  # noqa: E731
        -1, lane.clamp_min(0).long().transpose(2, 3))
    gap = (z(lane_k) - z(lane_p)).abs()[diff]
    assert float(gap.max()) <= 1e-6
    assert float(diff.any(-1).float().mean()) < 1e-3


# F=300 streams three shared-memory chunks; tile=32 is the 1024-thread
# maximum; blur 0 tests inside-only cover, blur > 0 the boundary band.
@pytest.mark.parametrize("B,A,F,tile,blur,clip", [
    (2, 3, 5, 4, 0.0, False), (2, 7, 64, 8, 1e-3, True),
    (1, 5, 300, 16, 1e-4, True), (3, 2, 40, 32, 0.0, False),
])
def test_hard_k1_matches_plain(device, B, A, F, tile, blur, clip):
    from torch_renderer_tpu_torch.rasterize import cuda_hard

    slab, count, origin = _hard_slabs(0, B, A, F, tile, device)
    args = (slab, count, origin, tile, 1.0 / 16, blur, 1e-5, clip)
    before = timing.counters()["hard_k1"]
    out = cuda_hard.hard_k1(*args)
    torch.cuda.synchronize()
    assert timing.counters()["hard_k1"] == before + 1
    ref = cuda_hard.hard_k1_reference(*args)
    lane = lambda o: torch.where(  # noqa: E731
        o[:, :, 6] > 0, o[:, :, 7], -1.0).round().int()[:, :, None]
    prio = cuda_hard._priority(slab, count, origin, tile, 1.0 / 16, blur,
                               1e-5)
    _equal_or_ties(lane(out), lane(ref), prio)
    same = lane(out) == lane(ref)
    assert float(((out - ref).abs() * same).max()) <= 1e-5
    # the empty tile carries the empty band everywhere
    empty = torch.tensor(cuda_hard.EMPTY_BAND, device=device)[:, None]
    assert bool((out[-1, -1] == empty).all())


def _hard_k1_plan(tile: int, tiles: int, device):
    """(P, R, S): the blocks a tile, rows a block and thread groups a
    pixel of a hard_k1 launch over `tiles` tiles on this card."""
    import ctypes

    from torch_renderer_tpu_torch import _build

    plan = (ctypes.c_int * 3)()
    assert _build.load_kernels().trt_hard_k1_plan(
        tile, tiles, ctypes.addressof(plan), device.index) == 0
    return tuple(plan)


# tests/test_torch_topk_split.py's slabs (ties from duplicated faces and
# equal-depth planes, several staging chunks, an empty tile),
# repeated over as many tiles as make the launcher take each of its plans
# at this tile (1 to 8192 tiles): winners and all 8 rows equal the plain
# version's.
@pytest.mark.parametrize("tile", [8, 16, 32])
def test_hard_k1_plans_match_plain(device, tile):
    from test_torch_topk_split import INV_S, topk_slabs

    from torch_renderer_tpu_torch.rasterize import cuda_hard

    plans = {}
    for k in range(53):
        tiles = max(1, round(2 ** (k / 4)))
        plans.setdefault(_hard_k1_plan(tile, tiles, device), tiles)
    found = {S for _, _, S in plans}
    assert min(found) == 1 and max(found) >= 4
    F = 300 if tile <= 16 else 150
    for (P, R, S), A in plans.items():
        base = topk_slabs(tile + S, 1, 6, F, tile)   # tile 0 full, 5 empty
        slab, count, origin = (t.repeat(1, -(-A // 6), *([1] * (t.ndim - 2)))
                               [:, :A].contiguous().to(device) for t in base)
        for blur, clip in ((0.0, False), (9.21e-4, True)):
            args = (slab, count, origin, tile, INV_S, blur, 1e-5, clip)
            before = timing.counters()["hard_k1"]
            out = cuda_hard.hard_k1(*args)
            torch.cuda.synchronize()
            assert timing.counters()["hard_k1"] == before + 1
            assert torch.equal(out, cuda_hard.hard_k1_reference(*args)), \
                (P, R, S)


# tests/test_torch_topk_split.py's slabs: faces with corners and edges on
# pixel centres, faces smaller than a pixel, slivers (the cull's slack),
# duplicated faces and equal-depth planes (ties), 150 candidates (two
# staging chunks) and an empty tile; tiles 8, 16 and 32 give 16, 4 and 1
# thread groups per pixel for K <= 16, and at tiles 25 and 32 with K > 25
# two or four blocks share a tile (at 25 the last block's last threads hold
# no pixel).
@pytest.mark.parametrize("blur", [0.0, 1e-4, 9.21e-4])
@pytest.mark.parametrize("K", [1, 4, 8, 16, 32, 50, 64])
@pytest.mark.parametrize("tile", [8, 16, 25, 32])
def test_topk_select_matches_plain(device, tile, K, blur):
    from test_torch_topk_split import INV_S, topk_slabs

    from torch_renderer_tpu_torch.rasterize import cuda_hard

    slab, count, origin = (t.to(device) for t in topk_slabs(
        tile + K, 2, 6, 150, tile))
    args = (slab, count, origin, K, tile, INV_S, blur, 1e-5)
    before = timing.counters()["topk_select"]
    lane = cuda_hard.topk_select(*args)
    torch.cuda.synchronize()
    assert timing.counters()["topk_select"] == before + 1
    ref = cuda_hard.topk_select_reference(*args)
    assert lane.shape == ref.shape == (2, 6, K, tile * tile)
    prio = cuda_hard._priority(slab, count, origin, tile, INV_S, blur, 1e-5)
    _equal_or_ties(lane, ref, prio)
    assert bool((lane[-1, -1] == -1).all())


def test_binned_raster_matches_cpu(device):
    """rasterize_meshes (K=1 and K=4, binned) and a vertex gradient on the
    card against the same calls on the CPU (plain versions)."""
    import torch_renderer_tpu_torch as trt

    verts, faces = trt.icosphere(2)
    f = 0.8 * 64
    K = np.array([[f, 0, 32], [0, f, 32], [0, 0, 1]], np.float32)
    t = np.array([[0.0, 0.0, 3.0], [0.2, -0.1, 2.5]], np.float32)
    for k, blur in ((1, 0.0), (4, 1e-4)):
        st = trt.RasterizationSettings((64, 64), blur_radius=blur,
                                       faces_per_pixel=k, bin_size=16)
        out = {}
        for dev in ("cpu", device):
            meshes = trt.Meshes.from_single(verts, faces, device=dev).extend(2)
            cam = trt.PerspectiveCamera.from_K(K, (64, 64), t=t, device=dev)
            v = meshes.verts.clone().requires_grad_(True)
            fr = trt.rasterize_meshes(meshes.update_padded(v), cam, st)
            (fr.zbuf * fr.mask).sum().backward()
            out[str(dev)] = (fr.pix_to_face.cpu(), fr.zbuf.detach().cpu(),
                             v.grad.cpu())
        (p_c, z_c, g_c), (p_g, z_g, g_g) = out["cpu"], out[str(device)]
        assert float((p_c != p_g).float().mean()) < 1e-3
        same = p_c == p_g
        torch.testing.assert_close(z_g[same], z_c[same], rtol=0, atol=1e-5)
        torch.testing.assert_close(g_g, g_c, rtol=0,
                                   atol=1e-3 * float(g_c.abs().max()))


# ---------------------------------------------------------------------------
# Texture-sampling kernels (csrc/texsample.cu)
# ---------------------------------------------------------------------------

def _tex_inputs(seed, B, Hm, Wm, C, P, device, shared):
    rng = np.random.default_rng(seed)
    maps = torch.tensor(rng.uniform(size=(1 if shared else B, Hm, Wm, C)),
                        dtype=torch.float32, device=device)
    if shared:
        maps = maps.expand(B, -1, -1, -1)       # batch stride 0
    y0 = rng.integers(-1, Hm, size=(B, P))      # includes clamped corners
    x0 = rng.integers(-1, Wm, size=(B, P))
    as_t = lambda a, dt: torch.tensor(a, dtype=dt, device=device)  # noqa
    return (maps, as_t(y0, torch.int32), as_t(x0, torch.int32),
            as_t(rng.uniform(size=(B, P)), torch.float32),
            as_t(rng.uniform(size=(B, P)), torch.float32),
            as_t(rng.normal(size=(B, P, C)), torch.float32))


@pytest.mark.parametrize("B,Hm,Wm,C,P,shared", [
    (2, 256, 256, 3, 32768, True), (2, 256, 256, 3, 32768, False),
    (3, 20, 100, 4, 257, False), (1, 2, 2, 1, 5, True),
])
def test_texsample_matches_plain(device, B, Hm, Wm, C, P, shared):
    from torch_renderer_tpu_torch.ops import cuda_texsample as ts

    maps, y0, x0, wy, wx, g = _tex_inputs(0, B, Hm, Wm, C, P, device, shared)
    before = _launches("texsample_fwd", "texsample_bwd")
    out = ts.texsample_fwd(maps, y0, x0, wy, wx)
    d_maps, d_wy, d_wx = ts.texsample_bwd(maps, y0, x0, wy, wx, g)
    torch.cuda.synchronize()
    assert _launches("texsample_fwd", "texsample_bwd") == (before[0] + 1,
                                                  before[1] + 1)
    ref = ts.texsample_fwd_reference(maps, y0, x0, wy, wx)
    r_maps, r_wy, r_wx = ts.texsample_bwd_reference(maps, y0, x0, wy, wx, g)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)
    for got, want in ((d_wy, r_wy), (d_wx, r_wx), (d_maps, r_maps)):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


def _tex_layout_inputs(seed, B, Hm, Wm, C, P, device, shared, layout):
    """layout "cluster": each warp's 32 points on one texel, or on it and 2
    to 4 neighbouring texels, a third of them empty fragments (corner
    (Hm - 2, 0), wy 1, wx 0, cotangent 0), and some cotangent channels
    exactly 0; "parity": corners at every x0, odd and even, on a map whose
    rows hold an odd number of floats, with the map and the cotangent
    starting 1 and 3 floats past a 16-byte boundary, so that the tap rows
    and the staged cotangent run meet every alignment."""
    rng = np.random.default_rng(seed)
    nb = 1 if shared else B
    off = 1 if layout == "parity" else 0
    store = torch.tensor(rng.uniform(size=nb * Hm * Wm * C + off),
                         dtype=torch.float32, device=device)
    maps = store[off:].view(nb, Hm, Wm, C)
    if shared:
        maps = maps.expand(B, -1, -1, -1)       # batch stride 0
    g = rng.normal(size=(B, P, C))
    g[rng.uniform(size=g.shape) < 0.1] = 0.0
    wy, wx = rng.uniform(size=(B, P)), rng.uniform(size=(B, P))
    if layout == "cluster":
        n = P // 32 + 1
        y = np.repeat(rng.integers(0, Hm - 3, size=(B, n)), 32, 1)[:, :P]
        x = np.repeat(rng.integers(0, Wm - 4, size=(B, n)), 32, 1)[:, :P]
        spread = np.repeat(rng.integers(0, 2, size=(B, n)), 32, 1)[:, :P]
        y0 = y + spread * rng.integers(0, 2, size=(B, P))
        x0 = x + spread * rng.integers(0, 3, size=(B, P))
        empty = rng.uniform(size=(B, P)) < 0.3
        y0[empty], x0[empty], wy[empty], wx[empty] = Hm - 2, 0, 1.0, 0.0
        g[empty] = 0.0
    else:
        y0 = rng.integers(0, Hm - 1, size=(B, P))
        x0 = np.resize(np.arange(Wm - 1), (B, P))
    gs = torch.zeros(B * P * C + 3, dtype=torch.float32, device=device)
    gt = gs[3:].view(B, P, C)
    gt.copy_(torch.tensor(g, dtype=torch.float32))
    as_t = lambda a, dt: torch.tensor(a, dtype=dt, device=device)  # noqa
    return (maps, as_t(y0, torch.int32), as_t(x0, torch.int32),
            as_t(wy, torch.float32), as_t(wx, torch.float32), gt)


@pytest.mark.parametrize("layout", ["cluster", "parity"])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("C", [1, 3, 4, 8, 10])
def test_texsample_layouts_match_plain(device, C, shared, layout):
    """The pair at clustered fragments (the backward's warp aggregation)
    and at every alignment of the tap rows, C in {1, 3, 4, 8} (their own
    instances) and 10 (the scalar kernel), shared and stacked maps; one
    launch per wrapper call."""
    from torch_renderer_tpu_torch.ops import cuda_texsample as ts

    Wm = 37 if layout == "parity" else 24
    args = _tex_layout_inputs(4, 2, 19, Wm, C, 1000, device, shared, layout)
    maps, y0, x0, wy, wx, g = args
    before = timing.counters()["texsample_fwd"]
    out = ts.texsample_fwd(maps, y0, x0, wy, wx)
    assert timing.counters()["texsample_fwd"] == before + 1
    before = timing.counters()["texsample_bwd"]
    d_maps, d_wy, d_wx = ts.texsample_bwd(*args)
    assert timing.counters()["texsample_bwd"] == before + 1
    torch.cuda.synchronize()
    ref = ts.texsample_fwd_reference(maps, y0, x0, wy, wx)
    r_maps, r_wy, r_wx = ts.texsample_bwd_reference(*args)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)
    for got, want in ((d_wy, r_wy), (d_wx, r_wx), (d_maps, r_maps)):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
    if layout == "cluster":
        # the empty fragments' corner gets only what live points add
        corner = r_maps[:, -2:, :2]
        torch.testing.assert_close(d_maps[:, -2:, :2], corner, rtol=0,
                                   atol=1e-5 * float(r_maps.abs().max()))


def test_textured_sample_matches_cpu(device):
    """TexturesUV.sample and its gradients to the shared map and to uv on
    the card against the same call on the CPU (plain versions)."""
    from torch_renderer_tpu_torch.structures.textures import TexturesUV

    rng = np.random.default_rng(1)
    base = rng.uniform(size=(64, 48, 3)).astype(np.float32)
    uv = rng.uniform(-0.1, 1.1, size=(2, 30, 20, 2)).astype(np.float32)
    out = {}
    for dev in ("cpu", device):
        m = torch.tensor(base, device=dev, requires_grad=True)
        u = torch.tensor(uv, device=dev, requires_grad=True)
        tex = TexturesUV(m[None].expand(2, -1, -1, -1),
                         torch.zeros((2, 1, 3), dtype=torch.int64,
                                     device=dev),
                         torch.zeros((2, 3, 2), device=dev))
        s = tex.sample(u)
        (s * s).sum().backward()
        out[str(dev)] = (s.detach().cpu(), m.grad.cpu(), u.grad.cpu())
    for a, b in zip(out[str(device)], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


def test_texsample_rejects_strided_maps(device):
    from torch_renderer_tpu_torch.ops import cuda_texsample as ts

    maps, y0, x0, wy, wx, _ = _tex_inputs(2, 2, 8, 8, 3, 10, device, False)
    with pytest.raises(ValueError, match="contiguous"):
        ts.texsample_fwd(maps.transpose(1, 2), y0, x0, wy, wx)
    with pytest.raises(ValueError, match="contiguous"):
        ts.texsample_fwd(maps, y0.t().contiguous().t(), x0, wy, wx)


# ---------------------------------------------------------------------------
# Point-selection kernel (csrc/points_select.cu)
# ---------------------------------------------------------------------------

def _point_slabs(seed, B, A, P, tile, device, per_point):
    """Random candidates around tiles at random origins: centres spread
    past the tile, z from 9 levels in [1, 3] (depth ties), r^2 uniform or
    per point, slot ids last; one full tile, one empty tile and one point
    at znear."""
    from torch_renderer_tpu_torch.rasterize.binning import tile_pixel_coords

    rng = np.random.default_rng(seed)
    span = tile / 16
    C = 5 if per_point else 4
    slab = np.zeros((B, A, P, C), np.float32)
    slab[..., :2] = rng.uniform(-0.2 * span, 1.2 * span, (B, A, P, 2))
    slab[..., 2] = rng.choice(np.linspace(1.0, 3.0, 9), (B, A, P))
    if per_point:
        slab[..., 3] = rng.uniform(0.0, (0.3 * span) ** 2, (B, A, P))
    slab[..., -1] = np.arange(P)
    slab[0, 0, 3, 2] = 0.0
    count = rng.integers(0, P + 1, (B, A))
    count[0, 0] = P
    count[-1, -1] = 0
    origin = rng.uniform(-1.0, 1.0, (B, A, 2))
    as_t = lambda a, dt: torch.tensor(a, dtype=dt, device=device)  # noqa
    return (as_t(slab, torch.float32), as_t(count, torch.int32),
            as_t(origin, torch.float32),
            tile_pixel_coords((32, 32), tile, device),
            None if per_point else float((0.3 * span) ** 2))


# P=600 streams three shared-memory chunks; tile 32 runs four blocks of 256
# pixels per tile; K=32 keeps more winners than most pixels have.
@pytest.mark.parametrize("K", [1, 8, 32])
@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("per_point", [False, True])
def test_points_select_matches_plain(device, K, tile, per_point):
    """Winner slots equal the plain version's exactly: the kernel repeats
    its coverage arithmetic op for op and its (z, slot) order."""
    from torch_renderer_tpu_torch.rasterize import cuda_points

    slab, count, origin, offs, r2 = _point_slabs(K + tile, 2, 5, 600, tile,
                                                 device, per_point)
    args = (slab, count, origin, offs, K, 1e-5, r2)
    before = timing.counters()["points_select"]
    lane = cuda_points.points_select(*args)
    torch.cuda.synchronize()
    assert timing.counters()["points_select"] == before + 1
    ref = cuda_points.points_select_reference(*args)
    assert lane.shape == ref.shape == (2, 5, K, tile * tile)
    assert torch.equal(lane, ref)
    assert bool((lane[-1, -1] == -1).all()) and bool((lane[0, 0] != 3).all())
    assert int((lane[0, 0, 0] >= 0).sum()) > 0


def _points_plan(tile: int, K: int, tiles: int, device):
    """(P, R, S): the blocks a tile, rows a block and thread groups a
    pixel of a points_select launch over `tiles` tiles with K winners on
    this card."""
    import ctypes

    from torch_renderer_tpu_torch import _build

    plan = (ctypes.c_int * 3)()
    assert _build.load_kernels().trt_points_plan(
        tile, K, tiles, ctypes.addressof(plan), device.index) == 0
    return tuple(plan)


# tests/test_torch_points_split.py's slabs (splats on pixel centres and
# exactly on a rim, points at and behind znear, duplicates, 300 candidates:
# two staging chunks), one tile 4x or more the mean count and an empty
# tile, repeated over as many tiles as make the launcher take each of its
# plans at this tile and K (1 to 8192 tiles): winners equal the plain
# version's.
@pytest.mark.parametrize("K", [8, 64])
@pytest.mark.parametrize("per_point", [False, True])
@pytest.mark.parametrize("tile", [8, 16, 32])
def test_points_select_plans_match_plain(device, tile, per_point, K):
    from test_torch_points_split import ZNEAR, point_slabs

    from torch_renderer_tpu_torch.rasterize import cuda_points

    plans = {}
    for k in range(53):
        tiles = max(1, round(2 ** (k / 4)))
        plans.setdefault(_points_plan(tile, K, tiles, device), tiles)
    assert min(S for _, _, S in plans) == 1
    slab, count, origin, offs, r2 = point_slabs(tile + K, 1, 6, 300, tile,
                                                per_point)
    count = torch.tensor([[300, 37, 0, 12, 25, 6]], dtype=torch.int32)
    assert int(count.max()) >= 4 * float(count.float().mean())
    for (P, R, S), A in plans.items():
        reps = -(-A // 6)
        sl, ct, org = (t.repeat(1, reps, *([1] * (t.ndim - 2)))[:, :A]
                       .contiguous().to(device)
                       for t in (slab, count, origin))
        args = (sl, ct, org, offs.to(device), K, ZNEAR, r2)
        before = timing.counters()["points_select"]
        lane = cuda_points.points_select(*args)
        torch.cuda.synchronize()
        assert timing.counters()["points_select"] == before + 1
        assert torch.equal(lane, cuda_points.points_select_reference(*args)), \
            (P, R, S)


def test_binned_points_match_cpu(device):
    """rasterize_points (binned, with features riding the gather, and with
    per-point radii) and the point gradient on the card against the same
    calls on the CPU (plain version)."""
    import torch_renderer_tpu_torch as trt

    rng = np.random.default_rng(0)
    pts = rng.normal(0, 0.4, (2, 3000, 3)).astype(np.float32)
    pts[..., 2] += 2.5
    radii = rng.uniform(0.01, 0.05, (2, 3000)).astype(np.float32)
    K = np.array([[51.2, 0, 32], [0, 51.2, 32], [0, 0, 1]], np.float32)
    st = trt.PointsRasterizationSettings((64, 64), radius=0.03,
                                         points_per_pixel=8, bin_size=16,
                                         max_points_per_bin=512)
    for radius in (None, radii):
        out = {}
        for dev in ("cpu", device):
            x = torch.tensor(pts, device=dev, requires_grad=True)
            cam = trt.PerspectiveCamera.from_K(K, (64, 64), device=dev)
            r = None if radius is None else torch.tensor(radius, device=dev)
            fr = trt.rasterize_points(trt.Pointclouds.from_padded(x), cam, st,
                                      radius=r, extra=x[..., 2:3] * 2.0)
            m = fr.mask
            loss = (torch.where(m, fr.zbuf + fr.dists2, 0.0).sum()
                    + fr.features.sum())
            (g,) = torch.autograd.grad(loss, x)
            out[str(dev)] = (fr.idx.cpu(), fr.zbuf.detach().cpu(),
                             fr.dists2.detach().cpu(), g.cpu())
        (i_c, z_c, d_c, g_c), (i_g, z_g, d_g, g_g) = (out["cpu"],
                                                      out[str(device)])
        same = i_c == i_g
        assert float((~same).any(-1).float().mean()) < 1e-3
        torch.testing.assert_close(z_g[same], z_c[same], rtol=0, atol=1e-6)
        torch.testing.assert_close(d_g[same], d_c[same], rtol=0, atol=1e-6)
        torch.testing.assert_close(g_g, g_c, rtol=0,
                                   atol=1e-3 * float(g_c.abs().max()))


def _gather_case(seed, B, T, S, F, C, device, dtype):
    rng = np.random.default_rng(seed)
    idx = np.full((B, T, S), -1, np.int64)
    for b in range(B):
        for t in range(T):
            n = rng.integers(0, S + 1)
            idx[b, t, :n] = np.sort(rng.choice(F, size=n, replace=False))
    table = rng.standard_normal((B, F, C)).astype(np.float32)
    g = rng.standard_normal((B, T, S, C)).astype(np.float32)
    return (torch.tensor(idx, dtype=dtype, device=device),
            torch.tensor(table, device=device), torch.tensor(g, device=device))


# (8, 128, 128) x 6: the soft slab; (1, 64, 224 / 192) x 13 and
# (1, 64, 128) x 6: the fits' slabs; (12, 336, 45) x 13: the depth call's,
# rows of 2340 bytes (a head and a tail); (1, 3, 1) x 3: rows too short for
# a 16-byte store.
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("B,T,S,F,C", [(2, 24, 16, 200, 12), (1, 5, 8, 130, 3),
                                       (8, 128, 128, 1280, 6),
                                       (1, 8, 8, 2300, 2),
                                       (1, 64, 224, 1280, 13),
                                       (1, 64, 192, 1280, 13),
                                       (1, 64, 128, 1280, 6),
                                       (12, 336, 45, 1280, 13),
                                       (1, 3, 1, 4, 3)])
def test_gather_tiles_matches_plain(device, dtype, B, T, S, F, C):
    from torch_renderer_tpu_torch.rasterize import cuda_gather as cg

    idx, table, g = _gather_case(0, B, T, S, F, C, device, dtype)
    before = _launches("gather_tiles_fwd", "gather_tiles_bwd")
    out = cg.gather_tiles_fwd(idx, table)
    dt = cg.gather_tiles_bwd(idx, g, F)
    torch.cuda.synchronize()
    assert _launches("gather_tiles_fwd", "gather_tiles_bwd") == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(out, cg.gather_tiles_reference(idx, table))
    ref = cg.gather_tiles_bwd_reference(idx, g, F)
    torch.testing.assert_close(dt, ref, rtol=0,
                               atol=1e-6 * float(ref.abs().max()))
    assert bool((out[idx < 0] == 0).all())


# ids outside [0, F) and an all-dead row, at rows whose byte size is and is
# not a multiple of 16 (tests/test_torch_gather_plan.py's cases)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("B,T,S,F,C", [(2, 3, 128, 40, 6), (1, 4, 45, 50, 13),
                                       (1, 2, 224, 300, 13), (2, 5, 7, 9, 1),
                                       (1, 3, 1, 4, 3)])
def test_gather_tiles_out_of_range_ids(device, dtype, B, T, S, F, C):
    from test_torch_gather_plan import _case

    from torch_renderer_tpu_torch.rasterize import cuda_gather as cg

    idx, table = (t.to(device) for t in _case(B + T + S, B, T, S, F, C,
                                               dtype))
    out = cg.gather_tiles_fwd(idx, table)
    torch.cuda.synchronize()
    assert torch.equal(out, cg.gather_tiles_reference(idx, table))
    assert bool((out[0, 0] == 0).all())


def test_gather_tiles_autograd(device):
    import torch_renderer_tpu_torch as trt

    idx, table, g = _gather_case(1, 2, 8, 8, 96, 4, device, torch.int64)
    t = table.clone().requires_grad_(True)
    (trt.gather_tiles(idx, t) * g).sum().backward()
    from torch_renderer_tpu_torch.rasterize import cuda_gather as cg

    ref = cg.gather_tiles_bwd_reference(idx, g, 96)
    torch.testing.assert_close(t.grad, ref, rtol=0,
                               atol=1e-6 * float(ref.abs().max()))


# The backward at every vector width (C = 6 and 13 occur; 4 and 12 take
# 16-byte atomics, 3 and 13 single floats), with ids drawn from one row in
# 16 slots (each repeated across many tiles: about 10 atomics to a row,
# few enough that float32 sums in two orders stay within the tolerance),
# one row of only dead slots, dead slots between live ones, ids outside
# [0, F), B > 1, and a cotangent whose rows are not 16-byte aligned (a
# view at an offset).
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("B,T,S,F,C", [(3, 8, 16, 7, 6), (1, 64, 128, 1280, 6),
                                       (2, 9, 7, 5, 13), (4, 5, 8, 3, 4),
                                       (2, 7, 10, 20, 12), (1, 1, 1, 1, 3)])
def test_gather_tiles_bwd_repeated_ids(device, dtype, B, T, S, F, C):
    from torch_renderer_tpu_torch.rasterize import cuda_gather as cg

    rng = np.random.default_rng(B * T + S)
    idx = rng.integers(0, max(1, min(F, T * S // 16)), size=(B, T, S))
    idx[rng.uniform(size=idx.shape) < 0.3] = -1
    idx[rng.uniform(size=idx.shape) < 0.05] = F + 3
    if T > 1:
        idx[-1, 1] = -1                             # a row of dead slots
    idx = torch.tensor(idx, dtype=dtype, device=device)
    base = torch.tensor(rng.standard_normal(B * T * S * C + 1),
                        dtype=torch.float32, device=device)
    for g in (base[:-1].reshape(B, T, S, C), base[1:].reshape(B, T, S, C)):
        before = timing.counters()["gather_tiles_bwd"]
        dt = cg.gather_tiles_bwd(idx, g, F)
        torch.cuda.synchronize()
        assert timing.counters()["gather_tiles_bwd"] == before + 1
        ref = cg.gather_tiles_bwd_reference(idx, g, F)
        torch.testing.assert_close(dt, ref, rtol=0,
                                   atol=1e-6 * float(ref.abs().max()))


# The kernel zeroes its own output: the entry point called on an output
# full of NaN gives the plain version's sums, and the wrapper's call puts
# one kernel on the device and no fill.
@pytest.mark.parametrize("B,T,S,F,C", [(8, 128, 128, 1280, 6),
                                       (1, 64, 128, 1280, 6), (2, 3, 5, 9, 13)])
def test_gather_tiles_bwd_zeroes_its_output(device, B, T, S, F, C):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from torch_renderer_tpu_torch._build import launch
    from torch_renderer_tpu_torch.rasterize import cuda_gather as cg

    idx, _, g = _gather_case(2, B, T, S, F, C, device, torch.int64)
    ref = cg.gather_tiles_bwd_reference(idx, g, F)
    dt = torch.full((B, F, C), float("nan"), device=device)
    launch("trt_gather_tiles_bwd", idx.data_ptr(), 1, g.data_ptr(),
           dt.data_ptr(), B, T * S, F, C, device=device)
    torch.cuda.synchronize()
    torch.testing.assert_close(dt, ref, rtol=0,
                               atol=1e-6 * float(ref.abs().max()))
    cg.gather_tiles_bwd(idx, g, F)
    # a profiler window can lose the records of its first kernels (after
    # earlier windows in the process), so it opens with int16 marker fills
    # and a synchronize, left out of the names
    marks = torch.empty(256, dtype=torch.int16, device=device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(len(marks)):
            marks[i].fill_(1)
        torch.cuda.synchronize()
        dt = cg.gather_tiles_bwd(idx, g, F)
        torch.cuda.synchronize()
    torch.testing.assert_close(dt, ref, rtol=0,
                               atol=1e-6 * float(ref.abs().max()))
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and "FillFunctor<short>" not in e.name]
    assert len(names) == 1 and "gather_bwd_kernel" in names[0], names


def _untile_case(seed, B, TH, TW, tile, A, C, device, dtype):
    rng = np.random.default_rng(seed)
    T = TH * TW
    rank = np.full((B, T), 10 ** 6, np.int64)
    for b in range(B):
        rank[b, rng.choice(T, A, replace=False)] = np.arange(A)
    rows = rng.standard_normal((B, A, tile * tile, C)) * 100
    return (torch.tensor(rows, device=device).to(dtype),
            torch.tensor(rank, device=device))


@pytest.mark.parametrize("dtype,C,bg", [(torch.float32, 1, -1.0),
                                        (torch.int64, 1, -1),
                                        (torch.float32, 3, 0.0),
                                        (torch.float32, 12, 2.0)])
@pytest.mark.parametrize("tile,crop", [(16, (5, 3)), (32, (0, 0)),
                                       (8, (7, 1))])
def test_untile_matches_plain(device, dtype, C, bg, tile, crop):
    from torch_renderer_tpu_torch.rasterize import cuda_untile as cu

    B, TH, TW, A = 2, 3, 5, 9
    rows, rank = _untile_case(0, B, TH, TW, tile, A, C, device, dtype)
    size = (TH * tile - crop[0], TW * tile - crop[1])
    table = cu.tile_slot_table(rank, A, (TH, TW))
    before = timing.counters()["untile_scatter"]
    img = cu.untile_scatter_fwd(rows, table, bg, size, tile, (TH, TW))
    torch.cuda.synchronize()
    assert timing.counters()["untile_scatter"] == before + 1
    assert img.dtype == dtype and tuple(img.shape) == (B,) + size + (C,)
    assert torch.equal(img, cu.untile_scatter_reference(
        rows, table, bg, size, tile, (TH, TW)))
    # strided rows: a channel slice of a wider field
    wide = torch.cat([rows, rows], dim=-1)[..., 1:C + 1]
    assert torch.equal(
        cu.untile_scatter_fwd(wide, table, bg, size, tile, (TH, TW)),
        cu.untile_scatter_reference(wide, table, bg, size, tile, (TH, TW)))


def _raster_fields(device, size, views, K, tile):
    """The binned raster's tile fields and slot table for `views` look-at
    views of the normalized level-3 icosphere at `size`: K=1 at blur 0, or
    K > 1 with the pose fit's blur."""
    import math

    import torch_renderer_tpu_torch as trt
    from torch_renderer_tpu_torch.rasterize import cuda_hard
    from torch_renderer_tpu_torch.rasterize import cuda_untile as cu

    H, W = size
    f = 0.9 * H
    Km = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    m = trt.Meshes.from_single(*trt.icosphere(3), device=device)
    m, _, _ = m.center_and_scale_to_unit_sphere()
    azim = np.linspace(0.0, 360.0, views, endpoint=False).astype(np.float32)
    R, t = trt.look_at_view_transform(2.7, 15.0, torch.from_numpy(azim))
    blur = 1e-4 * math.log(1 / 1e-4 - 1) if K > 1 else 0.0
    r = trt.MeshRenderer(Km, size, bin_size=tile, max_faces_per_bin=256,
                         faces_per_pixel=K, blur_radius=blur, device=device)
    fd = trt.setup_faces(m.extend(views), r.camera_with_pose(R.to(device),
                                                             t.to(device)))
    with torch.no_grad():
        bins, fields = cuda_hard.binned_tile_fields(fd, r.settings)
    table = cu.tile_slot_table(bins.rank, bins.invrank.shape[1],
                               bins.n_tiles_hw)
    flat = [(v.reshape(v.shape[:3] + (-1,)), bg) for v, bg in fields.values()]
    return flat, table, bins.n_tiles_hw


# The raster's four fields in one launch, at the depth app's 12-view 720p
# call (K=1, bin 32: float32 planes, bary's channels tile^2 apart, int64
# ids) and at the fits' 128^2 K=4 raster (bin 16: K channels tile^2 apart,
# bary's K x 3), each equal to its plain version.
@pytest.mark.parametrize("size,views,K,tile", [((720, 1280), 12, 1, 32),
                                               ((128, 128), 1, 4, 16)])
def test_untile_fields_match_plain(device, size, views, K, tile):
    from torch_renderer_tpu_torch.rasterize import cuda_untile as cu

    fields, table, nthw = _raster_fields(device, size, views, K, tile)
    before = timing.counters()["untile_scatter"]
    imgs = cu.untile_scatter_fields_fwd(fields, table, size, tile, nthw)
    torch.cuda.synchronize()
    assert timing.counters()["untile_scatter"] == before + 1
    want = cu.untile_scatter_fields_reference(fields, table, size, tile,
                                              nthw)
    for (rows, _), img, ref in zip(fields, imgs, want):
        assert img.dtype == rows.dtype and torch.equal(img, ref)


# Every read path of the kernel on one launch: channel planes (pixel
# stride 1) of 1-3 float32 or int64 channels, interleaved channels
# (contiguous rows), channel slices (unaligned: one load per element),
# K x 3 channels tile^2 apart, 5 channels (a thread per element), at tiles
# 8, 16, 25 (runs do not fit: per element) and 32 and cropped sizes.
@pytest.mark.parametrize("tile,crop", [(8, (7, 1)), (16, (0, 0)),
                                       (25, (3, 4)), (32, (5, 3))])
def test_untile_fields_read_paths(device, tile, crop):
    from torch_renderer_tpu_torch.rasterize import cuda_untile as cu

    B, TH, TW, A = 2, 3, 4, 7
    rng = np.random.default_rng(tile)
    rank = np.full((B, TH * TW), 10 ** 6, np.int64)
    for b in range(B):
        rank[b, rng.choice(TH * TW, A, replace=False)] = np.arange(A)
    table = cu.tile_slot_table(torch.tensor(rank, device=device), A,
                               (TH, TW))
    P = tile * tile

    def rows(C, dtype):
        v = rng.standard_normal((B, A, P, 2 * C + 1)) * 1e3
        return torch.tensor(v, device=device).to(dtype)

    f32, i64 = torch.float32, torch.int64
    planar = lambda r: r.transpose(2, 3).contiguous().transpose(2, 3)  # noqa
    kc = torch.tensor(rng.standard_normal((B, A, 4, 3, P)), device=device
                      ).float().permute(0, 1, 4, 2, 3).reshape(B, A, P, 12)
    fields = [(planar(rows(1, f32)[..., :1]), -1.0),
              (planar(rows(3, f32)[..., :3]), 0.0),
              (planar(rows(3, i64)[..., :3]), -1),
              (rows(1, i64)[..., :1].contiguous(), -1),
              (rows(3, f32)[..., :3].contiguous(), 2.0),
              (rows(3, f32)[..., 1:4], 0.5),
              (kc, 0.0),
              (rows(5, f32)[..., :5].contiguous(), 9.0)]
    size = (TH * tile - crop[0], TW * tile - crop[1])
    before = timing.counters()["untile_scatter"]
    imgs = cu.untile_scatter_fields_fwd(fields, table, size, tile, (TH, TW))
    torch.cuda.synchronize()
    assert timing.counters()["untile_scatter"] == before + 1
    want = cu.untile_scatter_fields_reference(fields, table, size, tile,
                                              (TH, TW))
    for i, (img, ref) in enumerate(zip(imgs, want)):
        assert torch.equal(img, ref), i


@pytest.mark.parametrize("act,K", [(None, 1), (40, 1), (None, 4)])
def test_untile_epilogue_matches_plain_on_card(monkeypatch, device, act, K):
    """Fragments through the untile kernel equal the plain epilogue's bit for
    bit on the card; the silhouette's vertex gradient through the kernel's
    wrapper agrees with the plain epilogue differentiated by autograd within
    1e-5 of its largest: the untile backward is exact, but the gradient's
    scatter-adds downstream (the winners' corner gather) sum in float32
    atomics whose order changes from run to run."""
    import math

    import torch_renderer_tpu_torch as trt
    from torch_renderer_tpu_torch.rasterize import cuda_hard
    from torch_renderer_tpu_torch.rasterize import cuda_untile as cu

    H, W = 144, 176
    f = 0.9 * H
    Km = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    verts, faces = trt.icosphere(3)
    m = trt.Meshes.from_single(verts, faces, device=device).extend(3)
    R, t = trt.look_at_view_transform(2.7, [15.0, 40.0, 65.0],
                                      [0.0, 120.0, 240.0])
    R, t = R.to(device), t.to(device)
    blur = 1e-4 * math.log(1 / 1e-4 - 1) if K > 1 else 0.0
    r = trt.MeshRenderer(Km, (H, W), bin_size=16, max_faces_per_bin=256,
                         active_tiles=act, faces_per_pixel=K,
                         blur_radius=blur, device=device)

    def run():
        v = m.verts.clone().requires_grad_(True)
        o = r.render(m.update_padded(v), R, t)
        (g,) = torch.autograd.grad((o.silhouette ** 2).sum(), v)
        return o.fragments, o.depth, g

    before = timing.counters()["untile_scatter"]
    fa, da, ga = run()
    # one per raster
    assert timing.counters()["untile_scatter"] == before + 1
    monkeypatch.setattr(cuda_hard, "untile_scatter_fields",
                        cu.untile_scatter_fields_reference)
    fb, db, gb = run()
    assert timing.counters()["untile_scatter"] == before + 1
    for name in ("pix_to_face", "zbuf", "bary", "dists"):
        assert torch.equal(getattr(fa, name), getattr(fb, name)), name
    assert torch.equal(da, db)
    torch.testing.assert_close(ga, gb, rtol=0,
                               atol=1e-5 * float(gb.abs().max()))


# ---------------------------------------------------------------------------
# The loops as replays of captured CUDA graphs (utils/graph.py) against
# their eager form. Both forms launch the same kernels with the same
# arithmetic (Adam capturable in both), so they differ only where float32
# atomics (the gather backward, the corner gather's index_add, the texture
# backward) add in a run-varying order: gradients within 1e-5 of their
# largest. Adam turns such last-bit differences into a share of a step on
# a component whose gradient is near zero, and a parameter that moved by
# a last bit can change which faces a pixel selects, so the later losses
# of the two forms part (by up to 1.8% at step 6 of 8 on the pose fit's
# fragments route at 64^2, measured on the card) while the parameters
# stay close (up to 0.054 of one step, 0.054 * lr). So the histories are
# held equal within 1e-4 for the first two steps (the same parameters, up
# to those last bits), the fitted parameters within a quarter of one
# step (0.25 * lr): a replay that did not see its updated inputs would
# miss whole steps.
# ---------------------------------------------------------------------------

def test_captured_bench_step_matches_eager(device):
    from torch_renderer_tpu_torch import bench

    p = bench.QUICK
    meshes, cam = bench.scene(p["batch"], p["image"], p["level"], device)
    captured, cfg = bench.make_step(meshes, cam, capture=True)
    eager, _ = bench.make_step(meshes, cam, cfg=cfg, capture=False)
    v_c = v_e = meshes.verts
    for _ in range(4):            # warm-up, capture + replay, 2 replays
        v_c, g_c = captured(v_c)
        v_e, g_e = eager(v_e)
        torch.testing.assert_close(g_c, g_e, rtol=0,
                                   atol=1e-5 * float(g_e.abs().max()))
    torch.testing.assert_close(v_c, v_e, rtol=0, atol=1e-6)
    torch.cuda.set_sync_debug_mode("error")
    try:                          # a replay reads nothing back
        for _ in range(3):
            v_c, _ = captured(v_c)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(v_c).all())


def test_step_graph_replays_without_counting(device):
    """A replay advances no wrapper count: only the warm-up step and the
    capture do."""
    from torch_renderer_tpu_torch import bench

    p = bench.QUICK
    meshes, cam = bench.scene(p["batch"], p["image"], p["level"], device)
    step, _ = bench.make_step(meshes, cam, capture=True)
    before = _launches("soft_coverage_fwd", "gather_tiles_bwd")
    v = meshes.verts
    for _ in range(5):
        v, _ = step(v)
    torch.cuda.synchronize()
    assert _launches("soft_coverage_fwd", "gather_tiles_bwd") == \
        (before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("route", ["fragments", "pallas"])
def test_captured_pose_fit_matches_eager(device, route):
    from torch_renderer_tpu_torch.apps._common import pinhole_K
    from torch_renderer_tpu_torch.cameras.look_at import (
        look_at_view_transform,
    )
    from torch_renderer_tpu_torch.opt import pose_fit as pf
    from torch_renderer_tpu_torch.ops.icosphere import icosphere
    from torch_renderer_tpu_torch.structures.meshes import Meshes

    meshes = Meshes.from_single(*icosphere(3), device=device)
    meshes, _, _ = meshes.center_and_scale_to_unit_sphere()
    R, t = look_at_view_transform(2.7, 15.0, 40.0)
    R, t = R[0].numpy(), t[0].numpy()
    fitter = pf.CameraPoseFitter(pinhole_K((64, 64)), (64, 64),
                                 pf.PoseFitConfig(lr=5e-3),
                                 silhouette_impl=route, device=device)
    refs = fitter.make_references(meshes, R, t)
    p0 = pf.pose_params_from_Rt(R, t + np.float32([0.06, -0.04, 0.05]),
                                device)
    pc, hc = fitter.fit(meshes, refs, p0, n_steps=8, capture=True)
    pe, he = fitter.fit(meshes, refs, p0, n_steps=8, capture=False)
    for k in pe:
        torch.testing.assert_close(pc[k], pe[k], rtol=0, atol=0.25 * 5e-3)
    for k in he:
        torch.testing.assert_close(hc[k][:2], he[k][:2], rtol=1e-4,
                                   atol=1e-6)
    assert float(hc["loss"][-1]) < float(hc["loss"][0])


def test_captured_joint_fit_matches_eager(device):
    """lr_decay_steps=2: the staircase, computed in the graph from the
    device counter, turns twice in 6 steps."""
    from torch_renderer_tpu_torch.apps._common import pinhole_K
    from torch_renderer_tpu_torch.opt import deform_color as dc
    from torch_renderer_tpu_torch.ops.icosphere import icosphere
    from torch_renderer_tpu_torch.structures.meshes import Meshes
    from torch_renderer_tpu_torch.structures.textures import (
        sphere_uv_mapping,
    )

    verts, faces = icosphere(2)
    src = Meshes.from_single(verts, faces, device=device)
    uvs = torch.as_tensor(sphere_uv_mapping(verts), device=device)
    tgt = src.offset_verts(src.verts[0] * torch.tensor([0.0, -0.3, -0.1],
                                                        device=device))
    cfg = dc.JointFitConfig(n_views=4, views_per_step=2, texture_size=32,
                            lr_decay_steps=2, n_steps=6)
    fitter = dc.JointShapeTextureFitter(pinhole_K((48, 48)), (48, 48), cfg,
                                        device=device)
    ds = fitter.make_dataset(tgt)
    pc, hc = fitter.fit(src, uvs, ds, torch.Generator().manual_seed(3),
                        capture=True)
    pe, he = fitter.fit(src, uvs, ds, torch.Generator().manual_seed(3),
                        capture=False)
    lr = {"deform": cfg.lr_verts, "texture_map": cfg.lr_texture}
    for k in pe:
        torch.testing.assert_close(pc[k], pe[k], rtol=0, atol=0.25 * lr[k])
    for k in he:
        torch.testing.assert_close(hc[k][:2], he[k][:2], rtol=1e-4,
                                   atol=1e-6)


# 3x3 SVD (csrc/svd3.cu), and the slice-5 loops captured ---------------------

def _covariances(device, kind: str, n: int):
    rng = np.random.default_rng({"random": 1, "rank2": 2, "reflected": 3}[
        kind])
    U, _, Vt = np.linalg.svd(rng.normal(size=(n, 3, 3)))
    S = np.abs(rng.normal(size=(n, 3))) + 0.1
    if kind == "rank2":
        S[:, 2] = 0.0
    if kind == "reflected":
        U = np.where(np.linalg.det(U @ Vt)[:, None, None] > 0,
                     U * np.array([1.0, 1.0, -1.0]), U)
    A = U * S[:, None, :] @ Vt
    return torch.tensor(A.astype(np.float32), device=device)


@pytest.mark.parametrize("kind", ["random", "rank2", "reflected"])
@pytest.mark.parametrize("n", [1, 127, 300, 5000])
def test_svd3_kernel_matches_plain(device, kind, n):
    """The kernel against its plain Jacobi (the same sweeps, rounded
    otherwise): s within 1e-4, u and vt within 1e-4 where the singular
    values lie 1e-2 of the largest apart (a singular vector of two nearly
    equal singular values turns with the last bits of its input; at rank
    2 the last column of u also takes its sign from a rounded zero), and
    torch.linalg.svd (u diag(s) vt rebuilds the input within 1e-5 of its
    largest; the Umeyama rotation within 1e-5 where s1 - s2 > 0.05 s0,
    its float32 error growing as s0 / (s1 - s2)); one launch a call."""
    from torch_renderer_tpu_torch.ops import cuda_svd3

    A = _covariances(device, kind, n)
    before = timing.counters()["svd3"]
    got = cuda_svd3.svd3(A)
    assert timing.counters()["svd3"] == before + 1
    plain = cuda_svd3.svd3_jacobi(A)
    U, S, Vt = got
    torch.testing.assert_close(S, plain[1], rtol=0, atol=1e-4)
    s = plain[1]
    gaps = s[:, :2] - s[:, 1:]
    apart = (gaps > 1e-2 * s[:, :1]).all(-1)
    if kind == "rank2":
        torch.testing.assert_close(U[apart][..., :2], plain[0][apart][..., :2],
                                   rtol=0, atol=1e-4)
        torch.testing.assert_close(U[apart][..., 2].abs(),
                                   plain[0][apart][..., 2].abs(), rtol=0,
                                   atol=1e-4)
    else:
        torch.testing.assert_close(U[apart], plain[0][apart], rtol=0,
                                   atol=1e-4)
    torch.testing.assert_close(Vt[apart], plain[2][apart], rtol=0, atol=1e-4)
    scale = float(A.abs().max())
    torch.testing.assert_close((U * S[:, None, :]) @ Vt, A, rtol=0,
                               atol=1e-5 * scale)
    eye = torch.eye(3, device=device).expand(n, 3, 3)
    torch.testing.assert_close(U.transpose(1, 2) @ U, eye, rtol=0,
                               atol=1e-6)
    lib = torch.linalg.svd(A)
    torch.testing.assert_close(S, lib[1], rtol=0, atol=1e-5 * scale)

    def rotation(U, Vt):
        d = torch.sign(cuda_svd3.det3(U @ Vt))
        D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)
        return U @ (D[..., None] * Vt)

    apart = (lib[1][:, 1] - lib[1][:, 2]) > 0.05 * lib[1][:, 0]
    torch.testing.assert_close(rotation(U, Vt)[apart],
                               rotation(lib[0], lib[2])[apart], rtol=0,
                               atol=1e-5)


def test_svd3_rejects_other_inputs(device):
    from torch_renderer_tpu_torch.ops import cuda_svd3

    with pytest.raises(ValueError):
        cuda_svd3.svd3(torch.zeros(4, 3, 3, device=device,
                                   dtype=torch.float64))
    with pytest.raises(ValueError):
        cuda_svd3.svd3(torch.zeros(4, 2, 3, device=device))


def test_captured_icp_matches_eager(device):
    from torch_renderer_tpu_torch.ops.icosphere import icosphere
    from torch_renderer_tpu_torch.opt import registration as reg

    verts, _ = icosphere(3)
    data = reg.create_register_data(
        torch.Generator().manual_seed(0), torch.tensor(verts, device=device),
        reg.RegisterDataConfig(n_objects=16, crop_fraction=0.3,
                               noise_std=0.005))
    sc = reg.register_batch(data, 20, capture=True)
    se = reg.register_batch(data, 20, capture=False)
    for a, b in zip(sc.RTs, se.RTs):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    torch.testing.assert_close(sc.rmse_history, se.rmse_history, rtol=0,
                               atol=1e-6)
    assert torch.equal(sc.converged, se.converged)


def test_captured_pose_search_matches_eager(device):
    from torch_renderer_tpu_torch.ops.icosphere import icosphere
    from torch_renderer_tpu_torch.opt import pose_search as ps

    verts, _ = icosphere(2)
    cloud = torch.tensor(verts * np.float32([1.0, 0.6, 0.3]), device=device)
    cfg = ps.PoseSearchConfig(n_hypotheses=128, n_elite=32, n_iters=4)
    s = ps.GMMPoseSearch(cloud, cfg)
    target = cloud + torch.tensor([0.1, 0.0, -0.1], device=device)
    oc = s.search(torch.Generator(device=device).manual_seed(0), target,
                  capture=True)
    oe = s.search(torch.Generator(device=device).manual_seed(0), target,
                  capture=False)
    for k in oe:
        torch.testing.assert_close(oc[k], oe[k], rtol=1e-5, atol=1e-6)


def test_captured_fd_fit_matches_eager(device):
    """Two launches a step of hard_k1, the gather and the untile kernel
    eager; the captured fit's parameters equal eager's within 1e-6."""
    from torch_renderer_tpu_torch.ops.icosphere import icosphere
    from torch_renderer_tpu_torch.opt import pose_fit_fd as fd
    from torch_renderer_tpu_torch.structures.meshes import Meshes

    K = np.float32([[57.6, 0, 32], [0, 57.6, 32], [0, 0, 1]])
    fitter = fd.FiniteDifferencePoseFitter(
        K, (64, 64), fd.FDPoseFitConfig(step_size=0.02, eps=2e-3),
        device=device)
    meshes = Meshes.from_single(*icosphere(3), device=device)
    ref = fitter.render_depth(meshes, fitter.pack([0, 0, 0], [0, 0, 3.0],
                                                  device=device))
    start = fitter.pack([0.05, -0.04, 0], [0.08, -0.06, 3.15],
                        device=device)
    counts = _launches("hard_k1", "gather_tiles_fwd", "untile_scatter")
    pe, he = fitter.fit(meshes, ref, start, n_steps=6, capture=False)
    after = _launches("hard_k1", "gather_tiles_fwd", "untile_scatter")
    assert [a - b for a, b in zip(after, counts)] == [12, 12, 12]
    pc, hc = fitter.fit(meshes, ref, start, n_steps=6, capture=True)
    torch.testing.assert_close(pc, pe, rtol=0, atol=1e-6)
    torch.testing.assert_close(hc["loss"], he["loss"], rtol=0, atol=1e-6)
    assert float(he["loss"][-1]) < float(fitter.loss(start, meshes, ref))


# -- the COCO data generator (datagen/) ---------------------------------------

def _coco_generator(device, **kw):
    from torch_renderer_tpu_torch.datagen import coco

    cfg = coco.DataGenConfig(image_size=(96, 128), views_per_scene=4,
                             view_chunk=2, **kw)
    return coco.COCODataGenerator(coco.ObjectLibrary.primitives(), cfg,
                                  device=device)


@pytest.mark.parametrize("kw", [dict(), dict(material_mode="texture",
                                             room=True, edge_maps=True)])
def test_coco_scene_on_card_matches_cpu(device, kw):
    """One scene through the generator on the card and on the CPU (the
    kernels' plain versions), from one seed: the same draws; seg equal
    except on under 0.1% of covered pixels (the card's face setup rounds
    otherwise, which can flip a selection-depth tie); rgb within 1 level,
    depth within 1 mm, normals within 1 where seg agrees; one hard_k1,
    gather and untile launch a chunk."""
    outs = {}
    for dev in (device, torch.device("cpu")):
        gen = _coco_generator(dev, **kw)
        rng = np.random.default_rng(3)
        scene, poses = gen.sample_scene(rng)
        before = _launches("hard_k1", "untile_scatter")
        outs[dev.type] = (gen.render_scene(scene, rng), poses, rng.uniform())
        if dev.type == "cuda":
            assert (timing.counters()["hard_k1"] - before[0],
                    timing.counters()["untile_scatter"] - before[1]) == (2, 2)
    (g, gp, gn), (c, cp, cn) = outs["cuda"], outs["cpu"]
    assert gn == cn and [p["category_id"] for p in gp] == \
        [p["category_id"] for p in cp]
    same = g["segmentation"] == c["segmentation"]
    covered = int((c["segmentation"] != 255).sum())
    assert (~same).sum() <= 1e-3 * covered
    i = lambda a: a.astype(np.int64)  # noqa: E731
    assert np.abs(i(g["rgb"]) - i(c["rgb"]))[same].max() <= 1
    assert np.abs(i(g["depth"]) - i(c["depth"]))[same].max() <= 1
    assert np.abs(i(g["normals"]) - i(c["normals"]))[same].max() <= 1


def test_coco_room_chunk_hard_k1_matches_plain(device):
    """hard_k1 at a textured room chunk whose bin budget exceeds 128 slots
    (the kernel streams them in chunks of 128) equals its plain version
    in all 8 rows."""
    from torch_renderer_tpu_torch.rasterize import cuda_hard
    from torch_renderer_tpu_torch.rasterize.geometry import setup_face_planes

    gen = _coco_generator(device, material_mode="texture", room=True)
    rng = np.random.default_rng(0)
    scene, _ = gen.sample_scene(rng)
    Rs, ts = gen._sample_view_poses(rng, 4, gen._object_centers(scene))
    gen._ensure_bin_capacity(scene.meshes.extend(4), Rs, ts)
    st = gen.renderer.settings
    fd = setup_face_planes(scene.meshes.extend(4),
                           gen.renderer.camera_with_pose(Rs, ts))
    inp = cuda_hard.binned_inputs(fd, st)
    assert int(inp.count.max()) > 128
    args = (inp.slab, inp.count, inp.origin, st.bin_size, inp.inv_s,
            st.blur_radius, st.znear, st.clip_bary)
    assert torch.equal(cuda_hard.hard_k1(*args),
                       cuda_hard.hard_k1_reference(*args))


def test_captured_settle_matches_eager(device):
    from torch_renderer_tpu_torch.datagen import physics as phys
    from torch_renderer_tpu_torch.ops.icosphere import icosphere

    sv, _ = icosphere(2)
    pts, _, r = phys.collision_proxies(sv * 0.12)
    xy = np.float32([[0, 0], [0.05, 0.01], [-0.2, 0.1]])
    p0, q0 = phys.drop_poses(np.random.default_rng(0), 3, xy,
                             np.float32([r] * 3))
    args = (np.stack([pts] * 3), np.float32([r] * 3), p0, q0,
            np.float32([1, 1, 0]))
    cfg = phys.SettleConfig(sim_steps=300, extent=0.47)
    Rc, tc, _ = phys.settle_poses(*args, cfg, device=device, capture=True)
    Re, te, _ = phys.settle_poses(*args, cfg, device=device, capture=False)
    torch.testing.assert_close(Rc, Re, rtol=0, atol=1e-6)
    torch.testing.assert_close(tc, te, rtol=0, atol=1e-6)
    Rh, th, _ = phys.settle_poses(*args, cfg, device="cpu")
    torch.testing.assert_close(te.cpu(), th, rtol=0, atol=1e-4)


def test_canny_on_card_matches_cpu(device):
    from torch_renderer_tpu_torch.ops.canny import canny_edges

    x = torch.rand((2, 48, 64, 3),
                   generator=torch.Generator().manual_seed(0)) * 255.0
    g = canny_edges(x.to(device), low_threshold=20.0)
    c = canny_edges(x, low_threshold=20.0)
    tol = 1e-4 * float(c.grad_magnitude.max())
    torch.testing.assert_close(g.grad_magnitude.cpu(), c.grad_magnitude,
                               rtol=0, atol=tol)
    torch.testing.assert_close(g.blurred.cpu(), c.blurred, rtol=0,
                               atol=1e-3)
    # the edge mask may differ only where a comparison Canny makes sits
    # within tol: the magnitude against the threshold or against a
    # neighbour it clears, or the orientation on a rounding boundary
    cmag = c.grad_magnitude
    H, W = cmag.shape[1:]
    p = torch.nn.functional.pad(cmag, (1, 1, 1, 1), value=-1e9)
    tie = torch.zeros_like(cmag, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                tie |= (cmag - p[:, 1 + dy:1 + dy + H,
                                 1 + dx:1 + dx + W]).abs() <= tol
    near = ((cmag - 20.0).abs() <= tol) | (tie & (cmag > 20.0 - tol)) \
        | (g.grad_orientation.cpu() != c.grad_orientation)
    thr, cthr = g.thresholded.cpu(), c.thresholded
    assert not (((thr > 0) != (cthr > 0)) & ~near).any()
    torch.testing.assert_close(thr[~near], cthr[~near], rtol=0, atol=tol)


# -- the jitted loops and calls captured (deform and vertex-colour fits, the
# depth app's calls, the COCO chunk and visibility count) -------------------

def test_captured_sampling_draws_as_eager(device):
    """A StepGraph of a surface sampling from a registered generator:
    every call draws what the same sampling draws eagerly from a
    generator of the same seed, consecutive replays differ, and the
    generator's offset moves as eager's does."""
    from torch_renderer_tpu_torch.ops.icosphere import icosphere
    from torch_renderer_tpu_torch.ops.sample_points import (
        sample_points_from_meshes,
    )
    from torch_renderer_tpu_torch.structures.meshes import Meshes
    from torch_renderer_tpu_torch.utils.graph import StepGraph

    mesh = Meshes.from_single(*icosphere(2), device=device)
    gc = torch.Generator(device=device).manual_seed(7)
    ge = torch.Generator(device=device).manual_seed(7)
    buf = torch.empty((1, 300, 3), device=device)

    def step():
        buf.copy_(sample_points_from_meshes(mesh, 300, gc))

    graph = StepGraph(step, device, True, (gc,))
    prev = None
    for _ in range(4):
        graph()
        want = sample_points_from_meshes(mesh, 300, ge)
        assert torch.equal(buf, want)
        assert gc.get_offset() == ge.get_offset()
        if prev is not None:
            assert not torch.equal(buf, prev)
        prev = buf.clone()
    assert graph.graph is not None


def _deform_problem(device):
    from torch_renderer_tpu_torch.ops.icosphere import icosphere
    from torch_renderer_tpu_torch.opt.deform import DeformConfig, MeshDeformer
    from torch_renderer_tpu_torch.structures.meshes import Meshes

    verts, faces = icosphere(2)
    src = Meshes.from_single(verts, faces, device=device)
    tgt = Meshes.from_single(verts * np.float32([1.0, 0.6, 0.4]), faces,
                             device=device)
    return MeshDeformer(src, target_meshes=tgt,
                        config=DeformConfig(n_samples=200))


def test_captured_deform_fit_matches_eager(device):
    """The same seed in both forms: the same draws each step (the
    generator is registered with the graph), so the first two chamfers
    within 1e-4 and the offsets within 1e-3 after 8 steps (float32
    atomics in the backward part them in their last bits)."""
    deformer = _deform_problem(device)
    out = {c: deformer.fit(torch.Generator(device=device).manual_seed(1),
                           n_steps=8, snapshot_every=3, capture=c)
           for c in (True, False)}
    (mc, dc_, hc, sc), (me, de, he, se) = out[True], out[False]
    torch.testing.assert_close(hc["chamfer"][:2], he["chamfer"][:2],
                               rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(dc_, de, rtol=0, atol=1e-3)
    assert len(sc) == len(se) == 2
    torch.testing.assert_close(sc[1].verts, se[1].verts, rtol=0, atol=1e-3)
    assert not torch.equal(sc[0].verts, sc[1].verts)
    assert float(hc["chamfer"][-1]) < float(hc["chamfer"][0])


def test_captured_vertex_color_fit_matches_eager(device):
    import dataclasses

    from torch_renderer_tpu_torch.apps._common import pinhole_K
    from torch_renderer_tpu_torch.cameras.look_at import (
        look_at_view_transform,
    )
    from torch_renderer_tpu_torch.ops.icosphere import icosphere
    from torch_renderer_tpu_torch.opt.deform import (
        ColorFitConfig,
        VertexColorFitter,
    )
    from torch_renderer_tpu_torch.structures.meshes import Meshes
    from torch_renderer_tpu_torch.structures.textures import TexturesVertex

    verts, faces = icosphere(2)
    meshes = Meshes.from_single(verts, faces, device=device)
    gt = dataclasses.replace(meshes, textures=TexturesVertex(torch.as_tensor(
        np.clip(0.5 + 0.5 * verts, 0, 1), device=device)[None]))
    Rs, ts = look_at_view_transform(2.7, 15.0,
                                    torch.tensor([0.0, 120.0, 240.0]))
    fitter = VertexColorFitter(pinhole_K((48, 48)), (48, 48),
                               ColorFitConfig(lr=5.0), device=device)
    refs = fitter.make_reference_views(gt, Rs, ts)
    rc, hc = fitter.fit(meshes, Rs, ts, refs, n_steps=8, capture=True)
    re_, he = fitter.fit(meshes, Rs, ts, refs, n_steps=8, capture=False)
    torch.testing.assert_close(hc["rgb_mse"][:2], he["rgb_mse"][:2],
                               rtol=1e-4, atol=1e-7)
    torch.testing.assert_close(rc, re_, rtol=0, atol=0.25 * 5.0 * 1e-3)
    assert float(hc["rgb_mse"][-1]) < float(hc["rgb_mse"][0])


def test_captured_depth_app_matches_eager(device):
    """The depth app's calls as replays (one graph for the chunk, one for
    the single view): its last pass's views equal the eager app's bit for
    bit; each kernel launches once a call run from the host."""
    from torch_renderer_tpu_torch.apps import batch_render_bench

    argv = ["--n-views", "6", "--view-chunk", "3", "--height", "72",
            "--width", "128", "--reps", "3", "--cards", "1"]
    out = {}
    for form in ("captured", "eager"):
        before = timing.counters()["hard_k1"]
        out[form] = batch_render_bench.main(
            argv + (["--eager"] if form == "eager" else []))
        out[form]["launched"] = timing.counters()["hard_k1"] - before
    c, e = out["captured"], out["eager"]
    assert torch.equal(c["views"], e["views"])
    assert c["calls"] == e["calls"] == e["traced"] == e["launched"]
    assert c["traced"] == c["launched"] == 4 < c["calls"]


def test_captured_coco_matches_eager(device):
    """Two scenes of different content through one captured generator
    (textured room, edges, the visibility check; four chunks a scene, so
    chunks replay) and an eager one: the packed outputs and the drawn
    views bit for bit."""
    from torch_renderer_tpu_torch.datagen import coco

    cfg = coco.DataGenConfig(image_size=(96, 128), views_per_scene=8,
                             view_chunk=2, material_mode="texture",
                             room=True, edge_maps=True, min_visible_px=60)
    gens = {form: coco.COCODataGenerator(
        coco.ObjectLibrary.primitives(), cfg, device=device,
        capture=form == "captured") for form in ("captured", "eager")}
    outs = {}
    for form, gen in gens.items():
        rng = np.random.default_rng(4)
        outs[form] = []
        for _ in range(2):
            scene, _ = gen.sample_scene(rng)
            outs[form].append(gen.render_scene(scene, rng))
    assert gens["captured"].renders_traced < gens["eager"].renders_traced
    for c, e in zip(outs["captured"], outs["eager"]):
        for k in ("rgb", "depth", "normals", "segmentation", "edges", "R",
                  "t"):
            np.testing.assert_array_equal(c[k], e[k], err_msg=k)
    assert not np.array_equal(outs["captured"][0]["rgb"],
                              outs["captured"][1]["rgb"])


# -- the multi-card layer (parallel/): two ranks -------------------------------

@pytest.fixture(scope="module")
def sharded_ranks():
    """tests/torch_parallel_cases.card_cases on two ranks: NCCL on two
    cards, or gloo with both on cuda:0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch_parallel_cases as cases
    from torch_renderer_tpu_torch.parallel.launch import run_ranks

    return run_ranks(cases.card_cases, 2, None, timeout=300)


def test_sharded_silhouette_kernels_on_the_card(sharded_ranks):
    """The face-sharded kernel route: each rank launches each soft kernel
    and each gather kernel once a call; alpha within 2e-4 of the
    single-rank route and the vertex gradient within 1e-3 of its
    largest (not 2x it)."""
    for r in sharded_ranks:
        c = r["sil"]["counts"]
        assert {k: v for k, v in c.items() if v} == {
            "soft_coverage_fwd": 1, "soft_coverage_bwd": 1,
            "gather_tiles_fwd": 1, "gather_tiles_bwd": 1}, c
    r0 = sharded_ranks[0]["sil"]
    a1, g1 = r0["single"]
    assert float((r0["alpha"] - a1).abs().max()) <= 2e-4
    assert float((r0["grad"] - g1).abs().max()) \
        <= 1e-3 * float(g1.abs().max())
    assert torch.equal(sharded_ranks[1]["sil"]["alpha"], r0["alpha"])


def test_sharded_registration_on_the_card(sharded_ranks):
    for r in sharded_ranks:
        assert r["icp"]["counts"]["svd3"] >= 1
    r0 = sharded_ranks[0]["icp"]
    for k in ("t", "R", "rmse"):
        torch.testing.assert_close(r0[k], r0["single"][k], rtol=1e-5,
                                   atol=1e-6)


def test_sharded_points_on_the_card(sharded_ranks):
    for r in sharded_ranks:
        c = r["points"]["counts"]
        assert {k: v for k, v in c.items() if v} == {
            "points_select": 1, "gather_tiles_fwd": 1}, c
    r0 = sharded_ranks[0]["points"]
    torch.testing.assert_close(r0["img"], r0["single"], rtol=0, atol=1e-5)


def test_sharded_datagen_on_the_card(sharded_ranks):
    """Each rank renders its half of each chunk of 4 views: one hard_k1,
    gather and untile launch a chunk (6 views: 2 chunks); the packed
    outputs equal the single-rank generator's."""
    for r in sharded_ranks:
        c = r["datagen"]["counts"]
        assert c["hard_k1"] == c["gather_tiles_fwd"] \
            == c["untile_scatter"] == 2, c
    r0 = sharded_ranks[0]["datagen"]
    for k, v in r0["out"].items():
        np.testing.assert_array_equal(v, r0["single"][k], err_msg=k)


def test_sharded_search_batch_one_target_a_rank_on_the_card(sharded_ranks):
    """search_batch of two targets over two ranks (one target a rank)
    equals the unsplit search of the two, and each of three targets
    searched alone from the batch's draws (G=1, what a rank holding one
    target runs) equals its row of the batch of three, bit for bit."""
    r0 = sharded_ranks[0]["search"]
    for n, v in r0["whole2"].items():
        for r in sharded_ranks:
            assert torch.equal(r["search"]["split"][n], v), n
    for g, alone in enumerate(r0["alone"]):
        for n, v in alone.items():
            assert torch.equal(v[0], r0["whole3"][n][g]), (g, n)


def _check_pose_step(ps):
    """The sharded pose step's default form against its eager form: the
    first two losses within 1e-4, the translations within 0.25 x lr over 5
    steps (float32 atomics in the backward part the forms' gradients in
    their last bits, as in test_captured_pose_fit_matches_eager), and the
    loss falls."""
    losses = ps["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    np.testing.assert_allclose(losses[:2], ps["eager"][:2], rtol=0,
                               atol=1e-4)
    assert float((ps["trail"] - ps["eager_trail"]).abs().max()) \
        <= 0.25 * 5e-3


def test_sharded_pose_step_on_the_card(sharded_ranks):
    """Two ranks: captured under NCCL (two cards), eager under gloo."""
    for r in sharded_ranks:
        _check_pose_step(r["pose_step"])
        if r["pose_step"]["backend"] == "gloo":
            assert r["pose_step"]["capture_true"].startswith("ValueError")


def test_sharded_pose_step_captured_under_nccl_on_the_card():
    """A world of one NCCL rank: the step is captured in a CUDA graph with
    the gradients' NCCL all_reduce inside (the mesh's axes of size 1 run
    no collective), and follows its eager form."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch_parallel_cases as cases
    from torch_renderer_tpu_torch.parallel.launch import run_ranks

    ps = run_ranks(cases.card_pose_step_one_rank, 1, "nccl", timeout=300)[0]
    assert ps["backend"] == "nccl"
    _check_pose_step(ps)


# ---------------------------------------------------------------------------
# Tiles past one block and K past the shared-memory lists: the shapes that
# JAX's binned paths run and a kernel block of 1024 threads does not hold
# ---------------------------------------------------------------------------

def _device_lists(entry: str, K: int) -> bool:
    """Whether the selection kernel's lists of K live in device memory."""
    from torch_renderer_tpu_torch import _build

    return bool(getattr(_build.load_kernels(), entry)(K))


# tiles 48 and 64 (blocks of two rows), 100 and 200 (blocks of one row,
# not whole warps) and 1100 (a row's columns split over two blocks, the
# WIDE instance; fewer candidates, for the plain version's memory): all 8
# rows equal the plain version's bit for bit, at blur 0 and in the blur
# band
@pytest.mark.parametrize("tile,B,A,F", [
    (48, 2, 3, 150), (64, 2, 3, 150), (100, 2, 3, 150), (200, 2, 3, 150),
    (1100, 1, 2, 30),
])
def test_hard_k1_wide_tiles_match_plain(device, tile, B, A, F):
    from test_torch_topk_split import INV_S, topk_slabs

    from torch_renderer_tpu_torch.rasterize import cuda_hard

    slab, count, origin = (t.to(device) for t in topk_slabs(
        tile, B, A, F, tile))
    for blur, clip in ((0.0, False), (9.21e-4, True)):
        args = (slab, count, origin, tile, INV_S, blur, 1e-5, clip)
        before = timing.counters()["hard_k1"]
        out = cuda_hard.hard_k1(*args)
        torch.cuda.synchronize()
        assert timing.counters()["hard_k1"] == before + 1
        assert torch.equal(out, cuda_hard.hard_k1_reference(*args)), blur


# tile 48 and 64 (several blocks a tile), K past 64 in shared memory (128,
# 812: one warp's lists fill it) and in device memory (813, 1000), at tile
# 16 and 64; 1100 candidates where K reaches 1000: winners equal
@pytest.mark.parametrize("tile,K,F", [
    (48, 4, 150), (64, 4, 150), (64, 50, 150), (16, 128, 300),
    (16, 812, 1100), (16, 813, 1100), (16, 1000, 1100), (64, 1000, 1100),
])
def test_topk_select_wide_matches_plain(device, tile, K, F):
    from test_torch_topk_split import INV_S, topk_slabs

    from torch_renderer_tpu_torch.rasterize import cuda_hard

    assert _device_lists("trt_topk_device_lists", K) == (K > 812)
    slab, count, origin = (t.to(device) for t in topk_slabs(
        tile + K, 2, 3, F, tile))
    for blur in (0.0, 9.21e-4):
        args = (slab, count, origin, K, tile, INV_S, blur, 1e-5)
        before = timing.counters()["topk_select"]
        lane = cuda_hard.topk_select(*args)
        torch.cuda.synchronize()
        assert timing.counters()["topk_select"] == before + 1
        ref = cuda_hard.topk_select_reference(*args)
        assert lane.shape == ref.shape == (2, 3, K, tile * tile)
        assert torch.equal(lane, ref), blur
        assert bool((lane[-1, -1] == -1).all())


# tiles 48 and 64, 200 (a row's columns split over two blocks), K past
# 64 in shared memory with smaller blocks (65, 300) and in device memory
# (877, 1000): winners equal
@pytest.mark.parametrize("tile,K,P", [
    (48, 8, 600), (64, 8, 600), (200, 8, 600), (16, 65, 600),
    (16, 300, 600), (16, 877, 1200), (64, 1000, 1200),
])
@pytest.mark.parametrize("per_point", [False, True])
def test_points_select_wide_matches_plain(device, tile, K, P, per_point):
    from torch_renderer_tpu_torch.rasterize import cuda_points

    assert _device_lists("trt_points_device_lists", K) == (K > 876)
    slab, count, origin, offs, r2 = _point_slabs(K + tile, 2, 3, P, tile,
                                                 device, per_point)
    args = (slab, count, origin, offs, K, 1e-5, r2)
    before = timing.counters()["points_select"]
    lane = cuda_points.points_select(*args)
    torch.cuda.synchronize()
    assert timing.counters()["points_select"] == before + 1
    ref = cuda_points.points_select_reference(*args)
    assert lane.shape == ref.shape == (2, 3, K, tile * tile)
    assert torch.equal(lane, ref)
    assert bool((lane[-1, -1] == -1).all())


def _tie_flips(q, count, g, tile: int, inv_s: float,
               inv_sigma: float) -> torch.Tensor:
    """(B, A, tile^2, K, 6): what a flipped edge tie can move each corner
    gradient of a (pixel, slot) pair by. Where a pixel's two nearest edges
    of the slot's face lie within 1e-5 (relative) of each other, float32
    rounding decides whether they tie (the term splits between them) and
    which is the nearer (the kernel and the plain version compute the
    distances in other forms); the most that can move is the difference
    of the two edges' full terms (soft_coverage_bwd_reference's), 0 for
    every other pair. At a vertex both edges' nearest point is the vertex
    and their terms are equal, so the common ties move nothing."""
    signed, d2, inside, live, edges = cuda_soft._pair_terms(q, count, tile,
                                                            inv_s)
    alpha = (g[..., None] * torch.sigmoid(-signed * inv_sigma) * -inv_sigma
             * torch.where(inside, -1.0, 1.0))
    alpha = torch.where(live, alpha, torch.zeros_like(alpha))
    terms = []
    for (a, b), (_, t, wx, wy, gx, gy) in zip(((0, 1), (1, 2), (2, 0)),
                                              edges):
        b2 = 2.0 * alpha
        ca, cg, cbw, cbg = b2 * (t - 1.0), b2 * t * (1.0 - t), -b2 * t, \
            b2 * t * t
        c = [torch.zeros_like(alpha)] * 6
        c[2 * a], c[2 * a + 1] = ca * wx + cg * gx, ca * wy + cg * gy
        c[2 * b], c[2 * b + 1] = cbw * wx + cbg * gx, cbw * wy + cbg * gy
        terms.append(torch.stack(c, dim=-1))
    terms = torch.stack(terms, dim=-2)                   # (B, A, P, K, 3, 6)
    dd = torch.stack([e[0] for e in edges], dim=-1)
    order = dd.argsort(-1)
    d0, d1 = (dd.gather(-1, order[..., i:i + 1])[..., 0] for i in (0, 1))
    near = ((d1 - d0) <= 1e-5 * d0) & live

    def nth(i):
        idx = order[..., i, None, None].expand(*order.shape[:-1], 1, 6)
        return terms.gather(-2, idx)[..., 0, :]

    return (nth(0) - nth(1)).abs() * near[..., None]


# tiles 48 (the backward's last pixel chunk a quarter full), 64 (4 forward
# blocks of 16 rows, 4 pixel chunks) and 100 (blocks of 10 rows in row
# order, 10 chunks), 300 candidates (three slot chunks): the forward within
# test_kernels_match_plain's bound; the backward too, plus on each slot
# what its pixels' flipped edge ties can move (_tie_flips: a tile of 10^4
# pixels holds a few such pixels), which at most 1% of the live slots may
# need; and, with the cotangent 0 at those pixels, the backward within
# the bound alone, every pixel chunk included
@pytest.mark.parametrize("tile", [48, 64, 100])
def test_soft_pair_wide_tiles_match_plain(device, tile):
    B, A, K, sigma = 2, 3, 300, 1e-4
    q, count = _slabs(tile, B, A, K, tile, device)
    inv_s, inv_sigma = 1.0 / 16, 1.0 / sigma
    g = torch.rand((B, A, tile * tile), device=device)
    before = _launches("soft_coverage_fwd", "soft_coverage_bwd")
    S = cuda_soft.soft_coverage_fwd(q, count, tile, inv_s, inv_sigma)
    dq = cuda_soft.soft_coverage_bwd(q, count, g, tile, inv_s, inv_sigma)
    torch.cuda.synchronize()
    assert _launches("soft_coverage_fwd", "soft_coverage_bwd") == \
        (before[0] + 1, before[1] + 1)
    S_ref = cuda_soft.soft_coverage_fwd_reference(q, count, tile, inv_s,
                                                  inv_sigma)
    dq_ref = cuda_soft.soft_coverage_bwd_reference(q, count, g, tile, inv_s,
                                                   inv_sigma)
    torch.testing.assert_close(S, S_ref, rtol=0,
                               atol=1e-4 + 1e-5 * float(S_ref.abs().max()))
    bound = 1e-3 * float(dq_ref.abs().max())
    flips = _tie_flips(q, count, g, tile, inv_s, inv_sigma)
    allowance = flips.sum(2)                                  # (B, A, K, 6)
    err = (dq - dq_ref).abs()
    assert bool((err <= bound + allowance).all()), \
        float((err - bound - allowance).max())
    tied = (allowance > 1e-6 * bound).any(-1)
    live = int(count.sum())
    tie_px = (flips > 1e-6 * bound).any(-1).any(-1)           # (B, A, P)
    print(f"tile {tile}: {int(tied.sum())} of {live} live slots hold a "
          f"flippable tie, on {int(tie_px.sum())} of {tie_px.numel()} "
          f"pixels; the largest allowance {float(allowance.max()):.4g} "
          f"against the bound {bound:.4g}; the largest gap there "
          f"{float(err[tied].max()) if bool(tied.any()) else 0.0:.4g}")
    assert int(tied.sum()) <= 0.01 * live
    del flips
    g0 = torch.where(tie_px, torch.zeros_like(g), g)
    dq0 = cuda_soft.soft_coverage_bwd(q, count, g0, tile, inv_s, inv_sigma)
    dq0_ref = cuda_soft.soft_coverage_bwd_reference(q, count, g0, tile,
                                                    inv_s, inv_sigma)
    torch.testing.assert_close(dq0, dq0_ref, rtol=0,
                               atol=1e-3 * float(dq0_ref.abs().max()))
    assert (S[-1, -1] == 0).all() and (dq[-1, -1] == 0).all()


# the binned entry points at bin 64 on the card against the same calls on
# the CPU: the mesh raster (K=1 and 4) with the vertex gradient of its
# depth over the pixels whose face ids agree on both (a pixel whose ids
# differ, from the projection's rounding, moves its gradient to other
# vertices), the soft silhouette with its gradient, and the point raster
def test_wide_bins_end_to_end_match_cpu(device):
    import torch_renderer_tpu_torch as trt

    verts, faces = trt.icosphere(2)
    f = 0.8 * 96
    Km = np.array([[f, 0, 48], [0, f, 48], [0, 0, 1]], np.float32)
    t = np.array([[0.0, 0.0, 3.0], [0.2, -0.1, 2.5]], np.float32)
    cases = ((1, 0.0), (4, 1e-4))

    def run(dev, agree=None):
        meshes = trt.Meshes.from_single(verts, faces, device=dev).extend(2)
        cam = trt.PerspectiveCamera.from_K(Km, (96, 96), t=t, device=dev)
        v = meshes.verts.clone().requires_grad_(True)
        res = {}
        for k, blur in cases:
            st = trt.RasterizationSettings((96, 96), blur_radius=blur,
                                           faces_per_pixel=k, bin_size=64,
                                           max_faces_per_bin=320)
            fr = trt.rasterize_meshes(meshes.update_padded(v), cam, st)
            w = 1.0 if agree is None else agree[k].to(dev)
            (g,) = torch.autograd.grad((fr.zbuf * fr.mask * w).sum(), v)
            res[k] = (fr.pix_to_face.cpu(), g.cpu())
        a = trt.soft_silhouette(meshes.update_padded(v), cam, tile=64,
                                impl="pallas")
        (g,) = torch.autograd.grad(a.sum(), v)
        res["soft"] = (a.detach().cpu(), g.cpu())
        pts = torch.as_tensor(verts, dtype=torch.float32,
                              device=dev)[None].expand(2, -1, -1)
        pr = trt.rasterize_points(
            trt.Pointclouds.from_padded(pts * 0.9 + torch.tensor(
                [0.0, 0.0, 2.5], device=dev)), cam,
            trt.PointsRasterizationSettings((96, 96), radius=0.05,
                                            points_per_pixel=8, bin_size=64,
                                            max_points_per_bin=200))
        res["points"] = pr.idx.cpu()
        return res

    c, d = run("cpu"), run(device)
    agree = {k: (c[k][0] == d[k][0]).all(-1, keepdim=True).float()
             for k, _ in cases}
    for k, _ in cases:   # ids differ on under 0.1% of pixels
        assert float(1.0 - agree[k].mean()) < 1e-3, k
    c, d = run("cpu", agree), run(device, agree)
    for k, _ in cases:
        torch.testing.assert_close(d[k][1], c[k][1], rtol=0,
                                   atol=1e-3 * float(c[k][1].abs().max()),
                                   msg=f"raster K={k} gradient")
    torch.testing.assert_close(d["soft"][0], c["soft"][0], rtol=0, atol=1e-4)
    torch.testing.assert_close(d["soft"][1], c["soft"][1], rtol=0,
                               atol=1e-3 * float(c["soft"][1].abs().max()),
                               msg="soft silhouette gradient")
    assert float((c["points"] != d["points"]).any(-1).float().mean()) < 1e-3

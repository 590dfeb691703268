"""Port parity: point-splat rasterization of torch_renderer_tpu_torch (the
dense path, and the binned path through the plain version of the
points_select kernel) against the JAX package on the CPU, plus the
kernel's plain version on hand-made slabs.

The scene is tests/test_points.py's: 64x64, f = 64, B=2 clouds of 400
points drawn from N(0, 0.4) at z ~ 2.5, radius 0.04, K=4, tile 16, 128
points per bin. The JAX binned path runs impl="xla" and impl="pallas" (its
Pallas kernel in interpret mode), over every tile and with 12 active tiles
(of 16 covered: tiles beyond the budget drop). Clouds are carried across
through interop.

Tolerances: point ids equal; zbuf, dists2 and features within 1e-6 (the
same float32 operations); gradients with respect to the points within
1e-4 of their largest (sums through gathers and scatter-adds in another
order). Each JAX function is compiled once for the file.
"""

import dataclasses
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_renderer_tpu as jtrt
from torch_renderer_tpu.rasterize.binning import (
    count_bbox_active_tiles as jcount_active,
)
from torch_renderer_tpu.rasterize.binning import (
    count_bbox_overflow as jcount_overflow,
)
from torch_renderer_tpu.rasterize.points import (
    PointsRasterizationSettings as JSettings,
)
from torch_renderer_tpu.rasterize.points import (
    project_points_screen as jproject,
)
from torch_renderer_tpu.rasterize.points import rasterize_points as jraster
from torch_renderer_tpu.structures.pointclouds import Pointclouds as JClouds
from torch_renderer_tpu_torch import PerspectiveCamera, interop
from torch_renderer_tpu_torch.rasterize import binning, cuda_points
from torch_renderer_tpu_torch.rasterize.points import (
    PointsRasterizationSettings,
    project_points_screen,
    rasterize_points,
    suggest_active_tiles_points,
    suggest_points_per_bin,
)
from torch_renderer_tpu_torch.structures.pointclouds import Pointclouds

H, W = 64, 64
F = 64.0
K_MAT = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
KW = dict(radius=0.04, points_per_pixel=4)
BIN = dict(bin_size=16, max_points_per_bin=128)


def _points(n=400, seed=0, batch=2, spread=0.4):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, spread, size=(batch, n, 3)).astype(np.float32)
    pts[..., 2] += 2.5
    return pts


def _extra(pts):
    """Two feature channels that depend on the points, so their gradient
    reaches them: (z, z)."""
    return np.repeat(pts[..., 2:3], 2, axis=-1)


def _pcam():
    return PerspectiveCamera.from_K(K_MAT, (H, W), device="cpu")


def _pcloud(pts):
    return interop.pointclouds_from_arrays(pts, [pts.shape[1]] * len(pts),
                                           device="cpu")


ACT = 12   # active-tile budget: the clouds cover all 16 tiles, so 4 drop


@pytest.fixture(scope="module")
def scene():
    """The JAX side of the scene, each function jitted and run once: dense
    fragments, binned fragments (xla and pallas, without and with active
    tiles), and the binned xla gradient of a loss over zbuf, dists2 and
    features."""
    pts = _points()
    jcam = jtrt.PerspectiveCamera.from_K(K_MAT, (H, W))
    base = JSettings((H, W), impl="xla", **KW, **BIN)
    w = jnp.cos(jnp.arange(H * W, dtype=jnp.float32)).reshape(1, H, W)

    def frags(p, st):
        return jraster(JClouds.from_padded(p), jcam, st,
                       extra=jnp.repeat(p[..., 2:3], 2, axis=-1))

    def loss(p):
        fr = frags(p, base)
        m = fr.mask
        contrib = (jnp.where(m, fr.zbuf, 0.0) + jnp.where(m, fr.dists2, 0.0)
                   + jnp.sum(fr.features, axis=-1))
        return jnp.sum(jnp.sum(contrib, axis=-1) * w)

    x = jnp.asarray(pts)
    out = {"pts": pts, "w": np.array(w),
           "dense": jax.jit(lambda p: jraster(
               JClouds.from_padded(p), jcam, JSettings((H, W), **KW)))(x),
           "grad": np.asarray(jax.jit(jax.grad(loss))(x))}
    for impl in ("xla", "pallas"):
        for act in (None, ACT):
            st = dataclasses.replace(base, impl=impl, active_tiles=act)
            out[impl, act] = jax.jit(lambda p, st=st: frags(p, st))(x)
    return out


def _assert_same(ours, ref, features=True):
    np.testing.assert_array_equal(ours.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_allclose(ours.zbuf.detach().numpy(),
                               np.asarray(ref.zbuf), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours.dists2.detach().numpy(),
                               np.asarray(ref.dists2), rtol=0, atol=1e-6)
    if features:
        np.testing.assert_allclose(ours.features.detach().numpy(),
                                   np.asarray(ref.features), rtol=0,
                                   atol=1e-6)


def test_dense_matches_jax(scene):
    ours = rasterize_points(_pcloud(scene["pts"]), _pcam(),
                            PointsRasterizationSettings((H, W), **KW))
    _assert_same(ours, scene["dense"], features=False)
    assert ours.features is None
    assert int((ours.idx[..., 0] >= 0).sum()) > 500


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("act", [None, ACT])
def test_binned_matches_jax(scene, impl, act):
    """The binned path through points_select's plain version against JAX
    binned with impl="xla" and impl="pallas" (interpret mode), over every
    tile and with an active-tile budget that drops tiles."""
    pts = scene["pts"]
    ours = rasterize_points(
        _pcloud(pts), _pcam(),
        PointsRasterizationSettings((H, W), active_tiles=act, **KW, **BIN),
        extra=torch.from_numpy(_extra(pts)))
    _assert_same(ours, scene[impl, act])
    if act is not None:          # the budget really dropped covered tiles
        assert int((ours.idx[..., 0] >= 0).sum()) < int(
            (np.asarray(scene["xla", None].idx)[..., 0] >= 0).sum())


def test_binned_gradients_match_jax(scene):
    pts = scene["pts"]
    x = torch.from_numpy(pts).requires_grad_(True)
    fr = rasterize_points(
        Pointclouds.from_padded(x), _pcam(),
        PointsRasterizationSettings((H, W), active_tiles=16, **KW, **BIN),
        extra=x[..., 2:3].repeat(1, 1, 2))
    m = fr.mask
    contrib = (torch.where(m, fr.zbuf, 0.0) + torch.where(m, fr.dists2, 0.0)
               + fr.features.sum(-1))
    loss = (contrib.sum(-1) * torch.from_numpy(scene["w"])).sum()
    (g,) = torch.autograd.grad(loss, x)
    want = scene["grad"]
    assert np.isfinite(g.numpy()).all()
    np.testing.assert_allclose(g.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_dense_and_binned_gradients_agree():
    """tests/test_points.py::test_binned_matches_dense_gradients on the
    port: the dense and binned recomputations give the same gradient."""
    pts = _points(n=200, batch=1)
    w = torch.cos(torch.arange(H * W, dtype=torch.float32)).reshape(1, H, W)

    def grad(bin_size):
        x = torch.from_numpy(pts).requires_grad_(True)
        fr = rasterize_points(
            Pointclouds.from_padded(x), _pcam(),
            PointsRasterizationSettings((H, W), radius=0.05,
                                        points_per_pixel=4,
                                        bin_size=bin_size,
                                        max_points_per_bin=128))
        m = fr.mask
        c = torch.where(m, fr.zbuf, 0.0) + torch.where(m, fr.dists2, 0.0)
        return torch.autograd.grad((c.sum(-1) * w).sum(), x)[0]

    torch.testing.assert_close(grad(16), grad(0), rtol=1e-4, atol=1e-4)


def test_sizing_matches_jax(scene):
    """Budget sizing reads the same counts as the JAX helpers."""
    pts = scene["pts"]
    st = PointsRasterizationSettings((H, W), **KW, bin_size=16)
    q, z, valid = project_points_screen(_pcloud(pts), _pcam(), st.znear)
    jq, jz, jv = jproject(JClouds.from_padded(jnp.asarray(pts)),
                          jtrt.PerspectiveCamera.from_K(K_MAT, (H, W)),
                          st.znear)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    r = st.radius
    args = (q - r, q + r, valid, (H, W), 16)
    jargs = (jq - r, jq + r, jv, (H, W), 16)
    mx, na = jcount_overflow(*jargs), jcount_active(*jargs)
    assert binning.count_bbox_overflow(*args) == mx
    assert binning.count_bbox_active_tiles(*args) == na
    # the JAX helpers' rounding of those counts
    assert suggest_points_per_bin(_pcloud(pts), _pcam(), st) == max(
        32, min(math.ceil(mx * 1.3 / 32) * 32, pts.shape[1]))
    assert suggest_active_tiles_points(_pcloud(pts), _pcam(), st) == max(
        8, min(math.ceil(na * 1.5 / 8) * 8, 16))
    with pytest.raises(ValueError, match="bin_size"):
        suggest_points_per_bin(_pcloud(pts), _pcam(),
                               PointsRasterizationSettings((H, W)))


def test_budget_step_off_128_multiples():
    """tests/test_points.py::test_lane_multiple_budget_nudge_grows_budget
    on the port: a budget on a multiple of 128 (below N) grows by 32, so a
    scene whose fullest tile holds 129-160 points renders the same at 128
    as at 160, and differently at a budget that really holds 128."""
    assert cuda_points.point_budget(128, 360) == 160
    assert cuda_points.point_budget(256, 260) == 260
    assert cuda_points.point_budget(96, 360) == 96
    assert cuda_points.point_budget(128, 128) == 128
    rng = np.random.default_rng(7)
    cluster = np.concatenate([rng.normal(0, 0.02, (100, 2)) + 0.35,
                              np.full((100, 1), 2.5)], axis=1)
    spread = rng.normal(0, 0.4, (260, 3))
    spread[:, 2] += 2.5
    pts = np.concatenate([cluster, spread]).astype(np.float32)[None]
    cloud, cam = _pcloud(pts), _pcam()
    base = PointsRasterizationSettings((H, W), **KW, **BIN)
    q, z, valid = project_points_screen(cloud, cam, base.znear)
    mx = binning.count_bbox_overflow(q - 0.04, q + 0.04, valid, (H, W), 16)
    assert 128 < mx <= 160, mx
    a = rasterize_points(cloud, cam, base)
    b = rasterize_points(cloud, cam, dataclasses.replace(
        base, max_points_per_bin=160))
    c = rasterize_points(cloud, cam, dataclasses.replace(
        base, max_points_per_bin=127))
    assert torch.equal(a.idx, b.idx) and torch.equal(a.zbuf, b.zbuf)
    assert not torch.equal(a.idx, c.idx)


def test_cloud_smaller_than_k():
    cloud = Pointclouds.from_padded(np.array([[[0.0, 0.0, 2.0]]], np.float32),
                                    device="cpu")
    for bin_size in (16, 0):
        fr = rasterize_points(cloud, _pcam(), PointsRasterizationSettings(
            (H, W), radius=0.05, points_per_pixel=8, bin_size=bin_size,
            max_points_per_bin=32))
        assert fr.idx.shape == (1, H, W, 8)
        hit = fr.idx[0, :, :, 0] >= 0
        assert bool(hit[H // 2, W // 2])
        assert int(fr.idx[..., 1:].max()) == -1
        assert bool((fr.zbuf[0, :, :, 0][hit] == 2.0).all())


def test_single_point_and_nearer_point():
    """tests/test_points.py's first flows: a point on the principal point
    covers the centre pixels at its depth; the nearer of two points on the
    axis takes slot 0; padded points never rasterize."""
    cam = _pcam()
    for bin_size in (0, 16):
        st = PointsRasterizationSettings((H, W), radius=0.05,
                                         points_per_pixel=2,
                                         bin_size=bin_size)
        one = rasterize_points(Pointclouds.from_padded(
            np.array([[[0.0, 0.0, 2.0]]], np.float32), device="cpu"), cam, st)
        hit = (one.idx[0, :, :, 0] >= 0).numpy()
        ys, xs = np.nonzero(hit)
        assert hit[H // 2, W // 2] and 3 <= hit.sum() <= 15
        assert abs(ys.mean() - (H - 1) / 2) < 1 and \
            abs(xs.mean() - (W - 1) / 2) < 1
        two = rasterize_points(Pointclouds.from_padded(
            np.array([[[0.0, 0.0, 3.0], [0.0, 0.0, 2.0]]], np.float32),
            device="cpu"), cam, st)
        assert two.idx[0, H // 2, W // 2].tolist() == [1, 0]
        padded = rasterize_points(Pointclouds.from_lists(
            [np.array([[0.0, 0.0, 2.0]], np.float32)], pad_to=16,
            device="cpu"), cam, st)
        assert int(padded.idx.max()) == 0


def test_input_guards_and_impl():
    cloud = _pcloud(_points(n=50, batch=1))
    cam = _pcam()
    with pytest.raises(ValueError, match="unknown impl"):
        rasterize_points(cloud, cam, PointsRasterizationSettings(
            (H, W), impl="mosaic", **BIN))
    # bin_size 64 (one tile of 4096 pixels) runs, as JAX's binned path
    # does, and selects what bin_size 16 selects
    wide, narrow = (rasterize_points(cloud, cam, PointsRasterizationSettings(
        (H, W), bin_size=b, max_points_per_bin=64, **KW)) for b in (64, 16))
    assert torch.equal(wide.idx, narrow.idx)
    assert int((wide.idx[..., 0] >= 0).sum()) > 50
    # the envelope guards read only shapes: zero-stride inputs suffice
    for n, size, match in ((70_000, 2048, "2\\^30"), (1 << 24, 16, "2\\^24")):
        q = torch.zeros(2).expand(1, n, 2)
        z = torch.ones(()).expand(1, n)
        with pytest.raises(ValueError, match=match):
            cuda_points.rasterize_points_binned_cuda(
                q, z, z > 0, z, PointsRasterizationSettings(
                    (size, size), bin_size=16))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        rasterize_points(cloud, cam, PointsRasterizationSettings(
            (H, W), impl="pallas", bin_size=0))
    assert any("DENSE point path" in str(w.message) for w in rec)


def test_point_bin_overflow_warns():
    """tests/test_budget_checks.py::test_point_bin_overflow_warns."""
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((1, 500, 3)).astype(np.float32) * 0.3
    cam = PerspectiveCamera.from_K(
        np.array([[0.8 * 64, 0, 32], [0, 0.8 * 64, 32], [0, 0, 1]],
                 np.float32), (64, 64),
        R=np.eye(3, dtype=np.float32)[None],
        t=np.array([[0.0, 0.0, 2.5]], np.float32), device="cpu")
    st = PointsRasterizationSettings((64, 64), radius=0.05, bin_size=16,
                                     max_points_per_bin=4,
                                     check_budgets="warn")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        rasterize_points(_pcloud(pts), cam, st)
    assert any("max_points_per_bin overflow" in str(w.message) for w in rec)


# ---------------------------------------------------------------------------
# the kernel's plain version on hand-made slabs
# ---------------------------------------------------------------------------

def _slabs(seed, B, A, P, tile, per_point):
    """Random candidates around each tile, one full tile and one empty."""
    rng = np.random.default_rng(seed)
    inv_s = 1.0 / 16
    span = tile * inv_s
    C = 5 if per_point else 4
    slab = np.zeros((B, A, P, C), np.float32)
    slab[..., :2] = rng.uniform(-0.2 * span, 1.2 * span, (B, A, P, 2))
    slab[..., 2] = rng.choice(np.linspace(1.0, 3.0, 9), (B, A, P))  # ties
    if per_point:
        slab[..., 3] = rng.uniform(0.0, (0.3 * span) ** 2, (B, A, P))
    slab[..., -1] = np.arange(P)
    slab[0, 0, 3, 2] = 0.0                     # at znear: never covers
    count = rng.integers(0, P + 1, (B, A)).astype(np.int32)
    count[0, 0] = P
    count[-1, -1] = 0
    origin = rng.uniform(-1, 1, (B, A, 2)).astype(np.float32)
    return (torch.from_numpy(slab), torch.from_numpy(count),
            torch.from_numpy(origin),
            binning.tile_pixel_coords((32, 32), tile), inv_s, span)


def _brute(slab, count, origin, offs, K, znear, r2):
    """Per pixel, the covering slots sorted by (z, slot), first K."""
    B, A, P, _ = slab.shape
    tp = offs.shape[0]
    out = np.full((B, A, K, tp), -1, np.int32)
    s, o, f = slab.numpy(), origin.numpy(), offs.numpy()
    for b in range(B):
        for a in range(A):
            px = f[:, 0] + o[b, a, 0]
            py = f[:, 1] + o[b, a, 1]
            for p in range(tp):
                hits = []
                for j in range(count[b, a]):
                    dx = np.float32(px[p] - s[b, a, j, 0])
                    dy = np.float32(py[p] - s[b, a, j, 1])
                    rr = s[b, a, j, 3] if r2 is None else np.float32(r2)
                    if (np.float32(dx * dx) + np.float32(dy * dy) <= rr
                            and s[b, a, j, 2] > znear):
                        hits.append((s[b, a, j, 2], j))
                hits.sort()
                for k, (_, j) in enumerate(hits[:K]):
                    out[b, a, k, p] = j
    return out


@pytest.mark.parametrize("K,tile,per_point", [(1, 4, False), (3, 4, True),
                                              (8, 8, False)])
def test_points_select_plain_version(K, tile, per_point):
    """The plain version (what the kernel is held to on the card) against
    a brute-force per-pixel sort by (z, slot)."""
    slab, count, origin, offs, _, span = _slabs(K, 2, 3, 20, tile,
                                                per_point)
    r2 = None if per_point else float((0.3 * span) ** 2)
    lane = cuda_points.points_select(slab, count, origin, offs, K, 1e-5, r2)
    assert lane.dtype == torch.int32 and lane.shape == (2, 3, K, tile ** 2)
    np.testing.assert_array_equal(
        lane.numpy(), _brute(slab, count, origin, offs, K, 1e-5, r2))
    assert (lane[-1, -1] == -1).all()
    assert (lane[0, 0] != 3).all()


def test_points_select_rejects_bad_inputs():
    slab, count, origin, offs, _, _ = _slabs(0, 1, 2, 8, 4, False)
    with pytest.raises(ValueError, match="count"):
        cuda_points.points_select(slab, count.long(), origin, offs, 2, 1e-5,
                                  0.01)
    with pytest.raises(ValueError, match="K must be"):
        cuda_points.points_select(slab, count, origin, offs, 0, 1e-5, 0.01)
    with pytest.raises(ValueError, match="C >= 4"):
        cuda_points.points_select(slab[..., :3].contiguous(), count, origin,
                                  offs, 2, 1e-5, None)
    with pytest.raises(ValueError, match="offs"):   # not tile^2 rows
        cuda_points.points_select(slab, count, origin,
                                  binning.tile_pixel_coords((64, 64), 33)[1:],
                                  2, 1e-5, 0.01)
    with pytest.raises(ValueError, match="device"):
        cuda_points.points_select(slab.to("meta"), count, origin, offs, 2,
                                  1e-5, 0.01)


def test_pointclouds_structure():
    """Pointclouds.from_lists / extend / transform / centroids / lists
    against the JAX structure."""
    a = np.arange(12, dtype=np.float32).reshape(4, 3)
    b = -np.arange(6, dtype=np.float32).reshape(2, 3)
    fa, fb = np.ones((4, 2), np.float32), np.zeros((2, 2), np.float32)
    ours = Pointclouds.from_lists([a, b], [fa, fb], pad_to=5, device="cpu")
    ref = JClouds.from_lists([a, b], [fa, fb], pad_to=5)
    R = np.stack([np.eye(3), np.diag([1.0, -1.0, -1.0])]).astype(np.float32)
    t = np.array([[1.0, 2.0, 3.0], [0.0, 0.0, 1.0]], np.float32)
    np.testing.assert_array_equal(ours.points.numpy(), np.asarray(ref.points))
    np.testing.assert_array_equal(ours.features.numpy(),
                                  np.asarray(ref.features))
    assert (ours.batch_size, ours.max_points) == (2, 5)
    np.testing.assert_allclose(
        ours.transform(torch.from_numpy(R), torch.from_numpy(t)).points,
        np.asarray(ref.transform(jnp.asarray(R), jnp.asarray(t)).points))
    np.testing.assert_allclose(ours.centroids(), np.asarray(ref.centroids()))
    ext = ours.extend(2)
    assert ext.points.shape == (4, 5, 3) and ext.num_points.tolist() == [
        4, 4, 2, 2]
    for x, y in zip(ours.points_list(), ref.points_list()):
        np.testing.assert_array_equal(x, y)
    assert ours.num_points_per_cloud().tolist() == [4, 2]
    assert ours.points_padded() is ours.points
    one = Pointclouds.from_padded(torch.zeros(7, 3))
    assert one.points.shape == (1, 7, 3) and one.num_points.tolist() == [7]

"""Port parity: the soft-silhouette kernel module (rasterize/cuda_soft.py) and
the streaming oracle of torch_renderer_tpu_torch against the JAX package, on
the CPU, where the port's kernel wrappers run their plain PyTorch versions
and the JAX Pallas kernels run in interpret mode.

Tolerances: coverage values within 1e-4 (the JAX packed-soft tests' bound
against the streaming oracle: float32 sums in another order); vertex
gradients within rtol/atol 5e-3 (the same tests' gradient bound: the TPU
moment-form backward and the port's product form round differently); the
hand-written plain backward within 1e-3 of max|grad| of autograd.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_renderer_tpu_torch as port
from torch_renderer_tpu.cameras.perspective import PerspectiveCamera
from torch_renderer_tpu.ops.icosphere import icosphere
from torch_renderer_tpu.rasterize import pallas_soft
from torch_renderer_tpu.rasterize.geometry import setup_face_planes
from torch_renderer_tpu.rasterize.soft import soft_silhouette_streaming
from torch_renderer_tpu.structures.meshes import Meshes
from torch_renderer_tpu_torch.interop import face_planes_from_arrays
from torch_renderer_tpu_torch.rasterize import cuda_soft
from torch_renderer_tpu_torch.utils import timing

IMG = 32
B = 2
SIGMA = 1e-4
K_INTR = np.array([[0.8 * IMG, 0, IMG / 2], [0, 0.8 * IMG, IMG / 2],
                   [0, 0, 1]], np.float32)
R = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3))
T_POSES = np.array([[0.0, 0.0, 3.0], [0.15, -0.1, 2.6]], np.float32)

# (layout, active_tiles, group_lanes, faces_per_tile): the packed cases of
# tests/test_packed_soft.py, and the lane route over every tile
ROUTES = [("packed", 4, None, 80), ("packed", 4, 256, 80),
          ("packed", 9, 256, 80), ("lane", None, None, 128)]


def _launches(*names) -> tuple:
    """The wrappers' launch counters (utils.timing), in order."""
    counts = timing.counters()
    return tuple(counts[n] for n in names)


@pytest.fixture(scope="module")
def scene():
    verts, faces = icosphere(1)
    jm = Meshes.from_single(verts, faces).extend(B)
    jc = PerspectiveCamera.from_K(K_INTR, (IMG, IMG), R=R, t=T_POSES)
    pm = port.Meshes.from_single(verts, faces, device="cpu").extend(B)
    pc = port.PerspectiveCamera.from_K(K_INTR, (IMG, IMG), R=R, t=T_POSES,
                                       device="cpu")
    jfp = setup_face_planes(jm, jc)
    return jm, jc, pm, pc, jfp, face_planes_from_arrays(
        *map(np.asarray, jfp), device="cpu")


def _route_kwargs(layout, active, group_lanes, fpt):
    return dict(sigma=SIGMA, tile=16, faces_per_tile=fpt, layout=layout,
                active_tiles=active, group_lanes=group_lanes)


@pytest.mark.parametrize("route", ROUTES, ids=str)
def test_fd_values_match_jax(scene, route):
    """Identical face planes into both packages' fused paths."""
    *_, jfp, pfp = scene
    kw = _route_kwargs(*route)
    want = np.asarray(pallas_soft.soft_silhouette_pallas_fd(
        jfp, (IMG, IMG), **kw))
    got = cuda_soft.soft_silhouette_fd(pfp, (IMG, IMG), **kw)
    assert tuple(got.shape) == (B, IMG, IMG)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    assert want.max() > 0.9
    S = cuda_soft.soft_silhouette_fd(pfp, (IMG, IMG), return_sum=True, **kw)
    np.testing.assert_allclose((1.0 - torch.exp(-S)).numpy(), want,
                               atol=1e-4)


@pytest.mark.parametrize("route", [ROUTES[1], ROUTES[3]], ids=str)
def test_fd_vertex_gradients_match_jax(scene, route):
    """d sum(alpha) / d verts through each package's own setup + path."""
    jm, jc, pm, pc, *_ = scene
    kw = _route_kwargs(*route)

    def jloss(v):
        fp = setup_face_planes(jm.update_padded(v), jc)
        return jnp.sum(pallas_soft.soft_silhouette_pallas_fd(
            fp, (IMG, IMG), **kw))

    want = np.asarray(jax.jit(jax.grad(jloss))(jm.verts))
    v = pm.verts.clone().requires_grad_(True)
    fp = port.setup_face_planes(pm.update_padded(v), pc)
    cuda_soft.soft_silhouette_fd(fp, (IMG, IMG), **kw).sum().backward()
    got = v.grad.numpy()
    assert np.isfinite(got).all() and np.abs(got).sum() > 0
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)


def _random_slabs(seed, B_=2, A=3, K=6, tile=8):
    """Random tile-frame triangles around a tile of a 32^2 image, and counts
    that leave some slots dead. Random corners give no exact edge ties."""
    rng = np.random.default_rng(seed)
    inv_s = 1.0 / (IMG / 2)
    span = tile * inv_s
    q = rng.uniform(-0.3 * span, 1.3 * span, size=(B_, A, K, 6))
    count = rng.integers(0, K + 1, size=(B_, A))
    count[0, 0] = K
    return (torch.tensor(q, dtype=torch.float32),
            torch.tensor(count, dtype=torch.int32), tile, inv_s)


@pytest.mark.parametrize("sigma", [1e-4, 1e-3])
def test_plain_backward_matches_autograd(sigma):
    q, count, tile, inv_s = _random_slabs(0)
    g = torch.from_numpy(np.random.default_rng(1).uniform(
        0.5, 1.5, size=(q.shape[0], q.shape[1], tile * tile)).astype(np.float32))
    qg = q.clone().requires_grad_(True)
    S = cuda_soft.soft_coverage_fwd_reference(qg, count, tile, inv_s,
                                              1.0 / sigma)
    (want,) = torch.autograd.grad((S * g).sum(), qg)
    got = cuda_soft.soft_coverage_bwd_reference(q, count, g, tile, inv_s,
                                                1.0 / sigma)
    assert want.abs().max() > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(),
                               atol=1e-3 * float(want.abs().max()))
    dead = torch.arange(q.shape[2]) >= count[..., None]
    assert (got[dead] == 0).all()


def test_plain_backward_splits_ties_evenly():
    """Pixel (0, 0) sits exactly 0.5 from two legs of a right isosceles
    triangle that is symmetric about the line y = x (the squared distances
    are exact in float32). The tied edges share the gradient evenly, as in
    the JAX backward, so the gradient keeps the mirror symmetry; giving it
    all to one edge would leave the corner off that edge with nothing."""
    tile, inv_s = 4, 0.5
    corners = np.array([[-0.5, -0.5], [1.5, -0.5], [-0.5, 1.5]])
    q = torch.tensor(corners.reshape(1, 1, 1, 6), dtype=torch.float32)
    count = torch.ones((1, 1), dtype=torch.int32)
    g = torch.zeros((1, 1, tile * tile))
    g[0, 0, 0] = 1.0                                   # pixel (0, 0) only
    dq = cuda_soft.soft_coverage_bwd_reference(q, count, g, tile, inv_s, 10.0)
    d = dq.reshape(3, 2).numpy()
    assert np.abs(d[2]).max() > 0
    assert d[0, 0] == d[0, 1]                          # corner 0 on the axis
    np.testing.assert_array_equal(d[1], d[2][::-1])    # corners 1, 2 mirror


def test_wrappers_take_the_plain_version_on_cpu():
    q, count, tile, inv_s = _random_slabs(2)
    g = torch.ones((q.shape[0], q.shape[1], tile * tile))
    launches = _launches("soft_coverage_fwd", "soft_coverage_bwd")
    assert torch.equal(
        cuda_soft.soft_coverage_fwd(q, count, tile, inv_s, 1e4),
        cuda_soft.soft_coverage_fwd_reference(q, count, tile, inv_s, 1e4))
    assert torch.equal(
        cuda_soft.soft_coverage_bwd(q, count, g, tile, inv_s, 1e4),
        cuda_soft.soft_coverage_bwd_reference(q, count, g, tile, inv_s, 1e4))
    assert _launches("soft_coverage_fwd", "soft_coverage_bwd") == launches


def test_wrappers_reject_bad_inputs():
    q, count, tile, inv_s = _random_slabs(3)
    with pytest.raises(ValueError, match="q must be float32"):
        cuda_soft.soft_coverage_fwd(q.double(), count, tile, inv_s, 1e4)
    with pytest.raises(ValueError, match="count must be int32"):
        cuda_soft.soft_coverage_fwd(q, count.long(), tile, inv_s, 1e4)
    with pytest.raises(ValueError, match="tile"):
        cuda_soft.soft_coverage_fwd(q, count, 0, inv_s, 1e4)
    with pytest.raises(ValueError, match="g must be float32"):
        cuda_soft.soft_coverage_bwd(q, count, torch.ones(2, 3, 5), tile,
                                    inv_s, 1e4)
    with pytest.raises(ValueError, match="no soft-coverage kernel"):
        cuda_soft.soft_coverage_fwd(q.to("meta"), count.to("meta"), tile,
                                    inv_s, 1e4)


def test_budget_checks_warn_on_overflow(scene):
    """check_budgets="warn" names each undersized budget; budgets sized by
    suggest_soft_config raise no warning."""
    import warnings

    *_, pfp = scene
    # at tile 8 the scene has up to 16 non-empty tiles, up to 41 candidates
    # in a tile and up to 142 in a group of 8 tiles
    for tight, want in (
        (dict(faces_per_tile=8, active_tiles=4, group_lanes=None),
         {"active_tiles", "faces_per_tile"}),
        (dict(faces_per_tile=80, active_tiles=16, group_lanes=128),
         {"group_lanes"}),
    ):
        with pytest.warns(RuntimeWarning) as record:
            cuda_soft.soft_silhouette_fd(pfp, (IMG, IMG), sigma=SIGMA, tile=8,
                                         layout="packed",
                                         check_budgets="warn", **tight)
        assert {str(w.message).split(" overflow")[0] for w in record} == want
    cfg = port.suggest_soft_config(pfp, (IMG, IMG), tile=8, sigma=SIGMA,
                                   layout="packed")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cuda_soft.soft_silhouette_fd(pfp, (IMG, IMG), sigma=SIGMA,
                                     check_budgets="warn", **cfg.kwargs())


def test_streaming_matches_jax(scene):
    jm, jc, pm, pc, *_ = scene
    want = np.asarray(soft_silhouette_streaming(jm, jc))
    got = port.soft_silhouette_streaming(pm, pc, pixel_chunk=300,
                                         face_chunk=32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    assert want.max() > 0.9


@pytest.mark.parametrize("layout", ["auto", "packed", "lane"])
def test_suggest_soft_config_matches_jax(scene, layout):
    *_, jfp, pfp = scene
    want = pallas_soft.suggest_soft_config(jfp, (IMG, IMG), sigma=SIGMA,
                                           layout=layout)
    got = port.suggest_soft_config(pfp, (IMG, IMG), sigma=SIGMA,
                                   layout=layout)
    assert got.kwargs() == want.kwargs()


def test_sublane_layout_matches_jax(scene):
    """layout="sublane" runs the lane route over every tile with the face
    budget rounded up to 8, which is what the JAX sublane kernels compute
    (tests/test_rank_binning.py::test_sublane_layout_matches_lane_layout).
    Against JAX's sublane kernels in interpret mode: values within 2e-5
    (measured 1.4e-5 here), vertex gradients within 5e-5 of their largest
    (measured 1.5e-5; the port's product-form backward rounds otherwise
    than the JAX moment form, and its lane route is 1.7e-5 off)."""
    jm, jc, pm, pc, jfp, pfp = scene
    kw = dict(sigma=SIGMA, faces_per_tile=80, layout="sublane")
    want = np.asarray(pallas_soft.soft_silhouette_pallas_fd(
        jfp, (IMG, IMG), **kw))
    got = cuda_soft.soft_silhouette_fd(pfp, (IMG, IMG), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    # the same route as lane at the rounded budget; the budgets and the
    # occupancy split of the other layouts are not read
    for fpt in (20, 80):
        lane = cuda_soft.soft_silhouette_fd(pfp, (IMG, IMG), sigma=SIGMA,
                                            faces_per_tile=-(-fpt // 8) * 8)
        sub = cuda_soft.soft_silhouette_fd(
            pfp, (IMG, IMG), sigma=SIGMA, faces_per_tile=fpt,
            layout="sublane", active_tiles=4, hi_tiles=8,
            check_budgets="warn")
        assert torch.equal(sub, lane)

    def jloss(v):
        fp = setup_face_planes(jm.update_padded(v), jc)
        return jnp.sum(pallas_soft.soft_silhouette_pallas_fd(
            fp, (IMG, IMG), **kw))

    gwant = np.asarray(jax.jit(jax.grad(jloss))(jm.verts))
    v = pm.verts.clone().requires_grad_(True)
    fp = port.setup_face_planes(pm.update_padded(v), pc)
    cuda_soft.soft_silhouette_fd(fp, (IMG, IMG), **kw).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), gwant, rtol=0,
                               atol=5e-5 * np.abs(gwant).max())

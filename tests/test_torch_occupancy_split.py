"""Port parity: the packed layout's occupancy split (hi_tiles, lo_lanes) and
the count-ordered active binning under it, against the JAX package on the
CPU (the port's kernel wrappers run their plain versions here; the JAX
packed Pallas kernels run in interpret mode).

Ranks, counts, slots and the sizing helpers must be identical. Coverage
within 1e-4 and vertex gradients within 2e-3 of their largest (the
tolerances of tests/test_packed_soft.py's split cases and of the port's
soft parity tests: float32 sums in another order, the port's product-form
backward against JAX's moment form).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_renderer_tpu_torch as port
from torch_renderer_tpu.cameras.perspective import PerspectiveCamera
from torch_renderer_tpu.ops.icosphere import icosphere
from torch_renderer_tpu.rasterize import binning as jbinning
from torch_renderer_tpu.rasterize import pallas_soft
from torch_renderer_tpu.rasterize.geometry import setup_face_planes
from torch_renderer_tpu.structures.meshes import Meshes
from torch_renderer_tpu_torch.interop import face_planes_from_arrays
from torch_renderer_tpu_torch.rasterize import binning as pbinning
from torch_renderer_tpu_torch.rasterize import cuda_soft

SIGMA = 1e-4
B = 2
IMG = 64
PAD = float(np.sqrt(16.0 * SIGMA))
VAL_TOL = 1e-4
GRAD_TOL = 2e-3


def _scene(img, level, f_scale, t):
    """Both packages' meshes, cameras and (identical) face planes."""
    verts, faces = icosphere(level)
    f = f_scale * img
    K = np.array([[f, 0, img / 2], [0, f, img / 2], [0, 0, 1]], np.float32)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3))
    jm = Meshes.from_single(verts, faces).extend(B)
    jc = PerspectiveCamera.from_K(K, (img, img), R=R, t=t)
    pm = port.Meshes.from_single(verts, faces, device="cpu").extend(B)
    pc = port.PerspectiveCamera.from_K(K, (img, img), R=R, t=t,
                                       device="cpu")
    jfp = setup_face_planes(jm, jc)
    pfp = face_planes_from_arrays(*map(np.asarray, jfp), device="cpu")
    return jm, jc, pm, pc, jfp, pfp


@pytest.fixture(scope="module")
def split_scene():
    """tests/test_packed_soft.py's split scene: 320 faces at 64^2."""
    return _scene(IMG, 2, 0.9, np.array([[0.0, 0.0, 2.2], [0.25, -0.2, 2.0]],
                                        np.float32))


@pytest.fixture(scope="module")
def far_scene():
    """A second one, where the split is sized: 320 faces at 128^2, farther
    off, so that the rim tiles hold few candidates."""
    return _scene(128, 2, 0.8, np.array([[0.0, 0.0, 3.0], [0.3, 0.2, 3.4]],
                                        np.float32))


# -- count-ordered ranks ---------------------------------------------------

def _boxes(seed, F=40):
    """Boxes on a coarse grid, so that many tiles tie in count."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 6, size=(B, F, 2)).astype(np.float32) * 0.25 - 0.9
    hi = lo + rng.integers(0, 3, size=(B, F, 2)).astype(np.float32) * 0.25
    return lo, hi, rng.random((B, F)) > 0.1


def _same_bins(pbins, jbins):
    for name in ("count", "invrank", "rank", "origin", "n_active"):
        np.testing.assert_array_equal(getattr(pbins, name).numpy(),
                                      np.asarray(getattr(jbins, name)),
                                      err_msg=name)
    # both use int32 max as the no-slot sentinel
    np.testing.assert_array_equal(pbins.slot.numpy(), np.asarray(jbins.slot))


@pytest.mark.parametrize("active", [64, 20, 5])
def test_count_ranks_match_jax(active):
    """Ties in count go to raster order; ranks at or beyond the budget drop
    (20 and 5 are below the non-empty count)."""
    lo, hi, valid = _boxes(0)
    jbins = jbinning.bin_ranks_active(jnp.asarray(lo), jnp.asarray(hi),
                                      jnp.asarray(valid), (IMG, IMG), 8,
                                      active, order="count")
    pbins = pbinning.bin_ranks_active(torch.tensor(lo), torch.tensor(hi),
                                      torch.tensor(valid), (IMG, IMG), 8,
                                      active, order="count")
    cnt = np.asarray(jbins.count)
    assert (np.diff(cnt[:, :min(active, 20)]) == 0).any()   # ties present
    assert int(np.asarray(jbins.n_active).min()) > 5
    _same_bins(pbins, jbins)


@pytest.mark.parametrize("active", [16, 9])
def test_count_bins_of_faces_match_jax(split_scene, active):
    *_, jfp, pfp = split_scene
    _same_bins(pbinning.bin_faces_active(pfp, (IMG, IMG), 16, PAD, active,
                                         order="count"),
               jbinning.bin_faces_active(jfp, (IMG, IMG), 16, PAD, active,
                                         order="count"))


def test_unknown_order_raises(split_scene):
    *_, pfp = split_scene
    with pytest.raises(ValueError, match="order"):
        pbinning.bin_faces_active(pfp, (IMG, IMG), 16, PAD, 16, order="x")


# -- sizing ------------------------------------------------------------------

@pytest.mark.parametrize("which", ["split_scene", "far_scene"])
def test_split_sizing_matches_jax(request, which):
    *_, jc, _, pc, jfp, pfp = request.getfixturevalue(which)
    size = pc.image_size
    for act, lo in ((16, 32), (64, 16), (64, 48)):
        assert cuda_soft.suggest_occupancy_split(
            pfp, size, active_tiles=act, lo_lanes=lo) == \
            pallas_soft.suggest_occupancy_split(
                jfp, size, active_tiles=act, lo_lanes=lo)
        for order in ("tile", "count"):
            assert cuda_soft.suggest_group_lanes(
                pfp, size, active_tiles=act, faces_per_tile=128,
                order=order) == pallas_soft.suggest_group_lanes(
                    jfp, size, active_tiles=act, faces_per_tile=128,
                    order=order)
    got = cuda_soft.suggest_soft_config(pfp, size, split=True)
    want = pallas_soft.suggest_soft_config(jfp, size, split=True)
    assert tuple(got) == tuple(want)
    assert tuple(cuda_soft.suggest_soft_config(pfp, size)) == \
        tuple(pallas_soft.suggest_soft_config(jfp, size))


def test_far_scene_sizes_a_split(far_scene):
    """The second scene is one where the split is sized (so the tests above
    compare a number, not only None)."""
    *_, pc, _, pfp = far_scene
    cfg = cuda_soft.suggest_soft_config(pfp, pc.image_size, split=True)
    assert cfg.hi_tiles is not None and cfg.hi_tiles % 8 == 0
    assert cfg.layout == "packed" and cfg.hi_tiles < cfg.active_tiles


# -- values and gradients under the split --------------------------------------

def _split_case(request, case):
    """A scene and its kwargs: (0) lo_lanes = faces_per_tile, so only the
    layout changes; (1) the split that suggest_soft_config(split=True)
    sizes; (2) an undersized lo_lanes, under which both packages drop a
    tail tile's candidates beyond it."""
    sc = request.getfixturevalue("far_scene" if case == 1 else "split_scene")
    pc, pfp = sc[3], sc[5]
    if case == 1:
        cfg = cuda_soft.suggest_soft_config(pfp, pc.image_size, split=True)
        kw = cfg.kwargs()
    else:
        kw = dict(tile=16, faces_per_tile=320, active_tiles=16,
                  layout="packed", group_lanes=1280, hi_tiles=8,
                  lo_lanes=320 if case == 0 else 6)
    return sc, dict(sigma=SIGMA, **kw)


@pytest.mark.parametrize("case", [0, 1, 2])
def test_split_values_match_jax(request, case):
    (*_, pc, jfp, pfp), kw = _split_case(request, case)
    size = pc.image_size
    want = np.asarray(pallas_soft.soft_silhouette_pallas_fd(jfp, size, **kw))
    got = cuda_soft.soft_silhouette_fd(pfp, size, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=VAL_TOL)
    unsplit = cuda_soft.soft_silhouette_fd(
        pfp, size, **{**kw, "hi_tiles": None}).numpy()
    if case < 2:
        np.testing.assert_allclose(got, unsplit, rtol=0, atol=1e-6)
    else:   # the undersized tail drops what JAX drops
        assert np.abs(unsplit - want).max() > 100 * VAL_TOL
        assert (got <= unsplit + 1e-6).all()


@pytest.mark.parametrize("case", [0, 1, 2])
def test_split_gradients_match_jax(request, case):
    (jm, jc, pm, pc, _, _), kw = _split_case(request, case)
    size = pc.image_size

    def jloss(v):
        fp = setup_face_planes(jm.update_padded(v), jc)
        return jnp.sum(pallas_soft.soft_silhouette_pallas_fd(fp, size, **kw))

    want = np.asarray(jax.jit(jax.grad(jloss))(jm.verts))
    v = pm.verts.clone().requires_grad_(True)
    fp = port.setup_face_planes(pm.update_padded(v), pc)
    cuda_soft.soft_silhouette_fd(fp, size, **kw).sum().backward()
    got = v.grad.numpy()
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GRAD_TOL * np.abs(want).max())


def test_split_ignored_by_lane_and_sublane(split_scene):
    """As in the JAX package, only the packed layout reads hi_tiles."""
    *_, pc, _, pfp = split_scene
    size = pc.image_size
    for layout in ("lane", "sublane"):
        kw = dict(sigma=SIGMA, faces_per_tile=320, layout=layout)
        assert torch.equal(
            cuda_soft.soft_silhouette_fd(pfp, size, hi_tiles=8, lo_lanes=6,
                                         **kw),
            cuda_soft.soft_silhouette_fd(pfp, size, **kw))


# -- validation and budget checks ---------------------------------------------

@pytest.mark.parametrize("hi", [5, 16])
def test_split_validation(split_scene, hi):
    """tests/test_packed_soft.py's errors: hi_tiles not a multiple of 8, or
    not below the active tiles."""
    *_, pc, _, pfp = split_scene
    with pytest.raises(ValueError, match="hi_tiles"):
        cuda_soft.soft_silhouette_fd(pfp, pc.image_size, faces_per_tile=320,
                                     active_tiles=16, layout="packed",
                                     hi_tiles=hi)


def test_split_budget_check_warns(split_scene):
    """check_budgets="warn" names the tail's lane budget when it drops (the
    JAX package's "occupancy_split lo_lanes" check), and stays silent at a
    sized split."""
    *_, pc, _, pfp = split_scene
    kw = dict(faces_per_tile=320, active_tiles=16, layout="packed",
              group_lanes=1280, hi_tiles=8, check_budgets="warn")
    with pytest.warns(RuntimeWarning, match="occupancy_split lo_lanes"):
        cuda_soft.soft_silhouette_fd(pfp, pc.image_size, lo_lanes=6, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cuda_soft.soft_silhouette_fd(pfp, pc.image_size, lo_lanes=320, **kw)

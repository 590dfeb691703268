"""The port's GMM pose search slice against the JAX package on the CPU:
ops/gmm.py (the EM from JAX's own k-means++ centres, log densities,
sampling by its moments), opt/pose_search.py (chamfer scores, the 6D pose
helpers, the elite selection, and tests/test_pose_search.py's gates on
the search, the batched search and the chamfer landscape), the plotting
helpers, the model registry and the pose_search and chamfer_eval apps.

The random streams differ (torch.Generator against jax.random), so what
depends on a draw is held to JAX's gates, and the rest to JAX's values on
the same numpy inputs. Tolerances: the EM within 1e-4 after 20 steps (the
same float32 arithmetic; sums in another order, then 20 rounds of
responsibilities); log densities within 1e-5; chamfer scores, poses and
pose errors within 1e-6 + 1e-4 relative; the elite set of a fixed score
vector equal (distinct scores, so no ties).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_renderer_tpu.ops import gmm as jgmm
from torch_renderer_tpu.ops.icosphere import icosphere as jicosphere
from torch_renderer_tpu.opt import pose_search as jps
from torch_renderer_tpu.transforms.so3 import (
    euler_angles_to_matrix as jeuler,
    transform_points as jtransform,
)
from torch_renderer_tpu_torch import models
from torch_renderer_tpu_torch.apps import chamfer_eval, pose_search
from torch_renderer_tpu_torch.ops import gmm
from torch_renderer_tpu_torch.opt import pose_search as ps
from torch_renderer_tpu_torch.rasterize.binning import (
    set_budget_check_default,
)
from torch_renderer_tpu_torch.transforms.so3 import (
    euler_angles_to_matrix,
    transform_points,
)
from torch_renderer_tpu_torch.utils import plotting


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cloud():
    """tests/test_pose_search.py's asymmetric cloud (162 points)."""
    verts, _ = jicosphere(2)
    pts = verts * np.array([1.0, 0.6, 0.3], np.float32)
    pts[:40] += np.array([0.8, 0.0, 0.0], np.float32)
    return torch.tensor(pts)


def _close(ours, theirs, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs),
                               atol=atol, rtol=rtol)


def _blobs(seed, n=120, d=6, k=3):
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=3.0, size=(k, d))
    X = centres[rng.integers(0, k, n)] + rng.normal(scale=0.4, size=(n, d))
    return X.astype(np.float32)


# ops/gmm.py ------------------------------------------------------------------

@pytest.mark.parametrize("k,seed", [(2, 0), (3, 1), (5, 2)])
def test_gmm_em_matches_jax(k, seed):
    """The EM from the centres JAX's _kmeanspp_init draws for the key JAX's
    gmm_fit uses, against gmm_fit."""
    X = _blobs(seed)
    key = jax.random.PRNGKey(seed)
    centres = np.asarray(jgmm._kmeanspp_init(key, jnp.asarray(X), k))
    theirs = jgmm.gmm_fit(key, jnp.asarray(X), k, n_iter=20)
    ours = gmm._gmm_em(torch.tensor(X), torch.tensor(centres), 20, 1e-6)
    for f in ("weights", "means", "var"):
        _close(getattr(ours, f), getattr(theirs, f), 1e-4)


def test_gmm_log_prob_matches_jax():
    X = _blobs(3)
    rng = np.random.default_rng(4)
    w = rng.dirichlet(np.ones(4)).astype(np.float32)
    mu = rng.normal(scale=2.0, size=(4, 6)).astype(np.float32)
    var = rng.uniform(0.1, 2.0, size=(4, 6)).astype(np.float32)
    ours = gmm.gmm_log_prob(gmm.DiagGMM(torch.tensor(w), torch.tensor(mu),
                                        torch.tensor(var)), torch.tensor(X))
    theirs = jgmm.gmm_log_prob(jgmm.DiagGMM(w, mu, var), jnp.asarray(X))
    _close(ours, theirs, 1e-5)


def test_gmm_sample_moments():
    w = torch.tensor([0.2, 0.5, 0.3])
    mu = torch.tensor([[-3.0, 0.0], [0.0, 2.0], [4.0, -1.0]])
    var = torch.tensor([[0.5, 0.2], [1.0, 0.3], [0.2, 0.8]])
    n = 40000
    s = gmm.gmm_sample(torch.Generator().manual_seed(0),
                       gmm.DiagGMM(w, mu, var), n)
    assert s.shape == (n, 2)
    mean = (w[:, None] * mu).sum(0)
    second = (w[:, None] * (var + mu * mu)).sum(0)
    sd = torch.sqrt(second - mean ** 2)
    # 5 standard errors of the sample mean and variance
    assert ((s.mean(0) - mean).abs() < 5 * sd / n ** 0.5).all()
    assert ((s.var(0) - sd ** 2).abs() < 5 * 2 * sd ** 2 / n ** 0.5 + 0.05
            ).all()
    # each sample lies near its component: the component shares hold
    near = torch.cdist(s, mu).argmin(-1)
    share = torch.bincount(near, minlength=3) / n
    _close(share, w, 0.02)


def test_kmeanspp_and_fit_recover_separated_blobs():
    rng = np.random.default_rng(5)
    truth = np.array([[-5.0, 0.0], [0.0, 5.0], [5.0, 0.0]], np.float32)
    X = torch.tensor(np.concatenate([
        c + 0.2 * rng.normal(size=(50, 2)) for c in truth]).astype(
            np.float32))
    centres = gmm._kmeanspp_init(torch.Generator().manual_seed(1), X, 3)
    # centres are rows of X, one in each blob
    assert bool((torch.cdist(centres, X).amin(-1) == 0).all())
    assert sorted(torch.cdist(centres, torch.tensor(truth)).argmin(-1)
                  .tolist()) == [0, 1, 2]
    fit = gmm.gmm_fit(torch.Generator().manual_seed(2), X, 3)
    order = torch.cdist(torch.tensor(truth), fit.means).argmin(-1)
    _close(fit.means[order], truth, 0.1)
    _close(fit.weights.sum(), 1.0, 1e-6)


# opt/pose_search.py ----------------------------------------------------------

def _poses(rng, H, centre=0.0):
    t = centre + 0.2 * rng.normal(size=(H, 3))
    rpy = rng.uniform(-np.pi, np.pi, size=(H, 3))
    return np.concatenate([t, rpy], -1).astype(np.float32)


def test_poses6d_and_pose_errors_match_jax():
    rng = np.random.default_rng(6)
    poses = _poses(rng, 32)
    for a, b in zip(ps.poses6d_to_Rt(torch.tensor(poses)),
                    jps.poses6d_to_Rt(jnp.asarray(poses))):
        _close(a, b, 1e-6, 1e-4)
    gt_R = np.asarray(jeuler(jnp.asarray([0.3, -0.2, 0.5]), "XYZ"))
    gt_t = np.array([0.1, 0.2, -0.1], np.float32)
    ours = ps.pose_errors(torch.tensor(poses), torch.tensor(gt_R),
                          torch.tensor(gt_t))
    theirs = jps.pose_errors(jnp.asarray(poses), jnp.asarray(gt_R),
                             jnp.asarray(gt_t))
    for a, b in zip(ours, theirs):
        _close(a, b, 1e-6, 1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_chamfer_scores_match_jax(cloud, masked):
    rng = np.random.default_rng(7)
    target = np.asarray(jtransform(jeuler(jnp.asarray([0.3, -0.2, 0.5]),
                                          "XYZ"),
                                   jnp.asarray([0.1, 0.2, -0.1]),
                                   jnp.asarray(cloud.numpy())))
    mask = (rng.uniform(size=len(target)) > 0.3).astype(np.float32) \
        if masked else None
    poses = _poses(rng, 24)
    ours = ps.chamfer_scores(cloud, torch.tensor(target), torch.tensor(poses),
                             None if mask is None else torch.tensor(mask))
    theirs = jps.chamfer_scores(jnp.asarray(cloud.numpy()),
                                jnp.asarray(target), jnp.asarray(poses),
                                None if mask is None else jnp.asarray(mask))
    _close(ours, theirs, 1e-6, 1e-4)


def test_chamfer_scores_batched_and_chunked(cloud, monkeypatch):
    """(G, H) scores equal the per-target calls, in one chunk or in chunks
    of 5 hypotheses."""
    rng = np.random.default_rng(8)
    targets = torch.tensor(rng.normal(size=(3, 100, 3)).astype(np.float32))
    masks = torch.tensor((rng.uniform(size=(3, 100)) > 0.2).astype(
        np.float32))
    poses = torch.tensor(np.stack([_poses(rng, 16) for _ in range(3)]))
    whole = ps.chamfer_scores(cloud, targets, poses, masks)
    monkeypatch.setattr(ps, "CHAMFER_CHUNK_ELEMS", 5 * len(cloud) * 100)
    chunked = ps.chamfer_scores(cloud, targets, poses, masks)
    assert whole.shape == (3, 16)
    assert torch.equal(whole, chunked)
    for g in range(3):
        _close(whole[g], ps.chamfer_scores(cloud, targets[g], poses[g],
                                           masks[g]), 1e-7)


def test_chamfer_scores_zero_at_gt(cloud):
    gt_rpy = torch.tensor([0.3, -0.2, 0.5])
    gt_t = torch.tensor([0.1, 0.2, -0.1])
    target = transform_points(euler_angles_to_matrix(gt_rpy, "XYZ"), gt_t,
                              cloud)
    s = ps.chamfer_scores(cloud, target, torch.cat([gt_t, gt_rpy])[None])
    assert float(s[0]) < 1e-6


def test_elite_set_matches_jax_top_k():
    rng = np.random.default_rng(9)
    scores = rng.uniform(size=(2, 200)).astype(np.float32)
    poses = rng.normal(size=(2, 200, 6)).astype(np.float32)
    e_poses, e_scores = ps._elite(torch.tensor(poses), torch.tensor(scores),
                                  40)
    for g in range(2):
        neg, idx = jax.lax.top_k(-jnp.asarray(scores[g]), 40)
        np.testing.assert_array_equal(e_scores[g].numpy(), -np.asarray(neg))
        np.testing.assert_array_equal(e_poses[g].numpy(),
                                      poses[g][np.asarray(idx)])


def _target(cloud, rpy, t):
    return transform_points(euler_angles_to_matrix(torch.tensor(rpy), "XYZ"),
                            torch.tensor(t), cloud)


SEARCH_CFG = ps.PoseSearchConfig(n_hypotheses=256, n_elite=64, n_iters=8,
                                 translation_std=0.3)
SEARCH_GT = ([0.4, -0.3, 0.8], [0.15, -0.1, 0.2])


def test_gmm_pose_search_improves_over_iterations(cloud):
    """tests/test_pose_search.py's score gates, and the history's
    invariants (its placement gate is the next test's)."""
    target = _target(cloud, *SEARCH_GT)
    out = ps.GMMPoseSearch(cloud, SEARCH_CFG).search(
        torch.Generator().manual_seed(0), target)
    hist = out["best_history"]
    assert torch.isfinite(hist).all() and hist[-1] <= hist[0]
    assert bool((hist[1:] <= hist[:-1]).all())
    assert float(out["score"]) < 0.05
    # the per-iteration records
    assert out["iter_poses"].shape == (8, 256, 6)
    assert out["gmm_means"].shape == (8, 5, 6)
    assert out["final_elite"].shape == (64, 6)
    assert float(hist[-1]) == float(out["score"])
    assert bool((out["elite_best_history"] >= hist).all())
    _close(out["iter_scores"].amin(-1), out["elite_best_history"], 0)
    _close(out["gmm_weights"].sum(-1), np.ones(8), 1e-5)
    _close(ps.chamfer_scores(cloud, target, out["pose6d"][None])[0],
           out["score"], 1e-7)


def test_pose_search_places_the_cloud_as_often_as_jax(cloud):
    """tests/test_pose_search.py's placement gate (mean point error of the
    found pose under 0.5) as a rate: the cloud is nearly symmetric, and
    chamfer cannot tell the pose from a flip of it (mean point error
    ~0.73), so the gate holds for 57 of 100 JAX keys and 48 of 100 of the
    port's seeds (the same search, 100 draws each, on the CPU). 8
    independent searches (one search_batch) must place the cloud at least
    twice, and score under 0.05 (JAX: 99 of 100) at least 7 times."""
    target = _target(cloud, *SEARCH_GT)
    out = ps.GMMPoseSearch(cloud, SEARCH_CFG).search_batch(
        torch.Generator().manual_seed(0), target.expand(8, -1, -1))
    moved = transform_points(out["R"], out["t"], cloud.expand(8, -1, -1))
    err = torch.linalg.norm(moved - target, dim=-1).mean(-1)
    assert int((err < 0.5).sum()) >= 2
    assert int((out["score"] < 0.05).sum()) >= 7


def test_chamfer_landscape_correlates_with_pose_error(cloud):
    out = ps.chamfer_loss_landscape(torch.Generator().manual_seed(1), cloud,
                                    torch.eye(3), torch.zeros(3), n_poses=400,
                                    translation_std=0.2, rotation_std=0.4)
    cham = out["chamfer"].numpy()
    assert np.isfinite(cham).all()
    assert np.corrcoef(cham, out["trans_err"].numpy())[0, 1] > 0.3
    # the landscape's own scores and errors
    _close(ps.chamfer_scores(cloud, cloud, out["poses6d"]), cham, 1e-7)


def test_batched_pose_search(cloud):
    rpys = [[0.3, -0.2, 0.5], [0.0, 0.4, -0.6], [-0.5, 0.1, 0.2]]
    ts = [[0.1, 0.0, 0.1], [0.0, 0.15, -0.05], [-0.1, 0.05, 0.0]]
    targets = torch.stack([_target(cloud, r, t) for r, t in zip(rpys, ts)])
    cfg = ps.PoseSearchConfig(n_hypotheses=192, n_elite=48, n_iters=5,
                              translation_std=0.25)
    out = ps.GMMPoseSearch(cloud, cfg).search_batch(
        torch.Generator().manual_seed(0), targets)
    assert out["pose6d"].shape == (3, 6) and out["R"].shape == (3, 3, 3)
    assert out["iter_poses"].shape == (3, 5, 192, 6)
    scores = out["score"].numpy()
    assert np.isfinite(scores).all() and (scores < 0.12).all()


def test_search_is_deterministic_and_sharding_takes_a_mesh(cloud):
    """The search repeats itself from one seed; its device_mesh forms take
    a DeviceMesh (TypeError for anything else) and, on a mesh of one rank,
    equal the plain search (tests/test_torch_parallel.py runs them split
    over 8 ranks)."""
    from torch_renderer_tpu_torch.parallel import make_mesh, run_ranks

    cfg = ps.PoseSearchConfig(n_hypotheses=32, n_elite=8, n_iters=2)
    s = ps.GMMPoseSearch(cloud, cfg)
    target = _target(cloud, [0.1, 0.2, 0.3], [0.0, 0.1, 0.0])
    a = s.search(torch.Generator().manual_seed(3), target)
    b = s.search(torch.Generator().manual_seed(3), target)
    assert all(torch.equal(a[k], b[k]) for k in a)
    for call in (lambda: s.search(None, target, device_mesh=object()),
                 lambda: s.search_batch(None, target[None],
                                        device_mesh=object()),
                 lambda: s._sharded_search_fn(object())):
        with pytest.raises(TypeError, match="DeviceMesh"):
            call()
    c, cb = run_ranks(lambda: (
        s.search(torch.Generator().manual_seed(3), target,
                 device_mesh=make_mesh((1, 1))),
        s.search_batch(torch.Generator().manual_seed(3), target[None],
                       device_mesh=make_mesh((1, 1)))), 1, "gloo")[0]
    assert all(torch.equal(a[k], c[k]) for k in a)
    assert all(torch.equal(a[k], cb[k][0]) for k in a)
    with pytest.raises(ValueError, match="capture=True"):
        s.search(torch.Generator().manual_seed(3), target, capture=True)


def test_model_registry_matches_jax():
    from torch_renderer_tpu import models as jmodels

    assert sorted(models.MODEL_FAMILIES) == sorted(jmodels.MODEL_FAMILIES)
    for k, cls in models.MODEL_FAMILIES.items():
        assert cls.__name__ == jmodels.MODEL_FAMILIES[k].__name__
        assert cls.__module__.startswith("torch_renderer_tpu_torch.")


# plotting and the apps -------------------------------------------------------

def test_plotting_helpers():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    g = gmm.DiagGMM(torch.tensor([0.3, 0.7]), torch.zeros(2, 6),
                    torch.ones(2, 6))
    ax = plotting.plot_gmm_ellipses(g, points=torch.zeros(10, 2))
    assert len(ax.patches) == 2
    ax = plotting.plot_gaussian_wireframe(torch.zeros(3), torch.eye(3))
    assert ax.name == "3d"
    plt.close("all")


@pytest.fixture
def app_budget_default():
    """The apps set the process-wide budget-check default for their run;
    put the default (None) back, so later tests in this process see it."""
    yield
    set_budget_check_default(None)


def test_pose_search_app_runs(tmp_path, capsys, app_budget_default):
    pytest.importorskip("matplotlib")
    plot_dir = tmp_path / "em"
    out = pose_search.main(["--device", "cpu", "--points", "96",
                            "--hypotheses", "48", "--elite", "12",
                            "--iters", "3", "--refine", "--batch", "2",
                            "--plot-dir", str(plot_dir)])
    text = capsys.readouterr().out
    assert "pose error: trans" in text and "wrote 3 EM-iteration" in text
    assert "after ICP refinement" in text and "batched search over 2" in text
    files = sorted(p.name for p in plot_dir.glob("em_iter_*.png"))
    assert files == ["em_iter_00.png", "em_iter_01.png", "em_iter_02.png"]
    hist = out["best_history"]
    assert np.isfinite(hist).all() and (hist[1:] <= hist[:-1]).all()
    assert out["batch_scores"].shape == (2,)
    # --mesh-shape 1,1: a world of one rank, in this process
    meshed = pose_search.main(["--device", "cpu", "--points", "96",
                               "--hypotheses", "48", "--elite", "12",
                               "--iters", "3", "--batch", "2",
                               "--mesh-shape", "1,1"])
    assert "device mesh {'data': 1, 'model': 1}" in capsys.readouterr().out
    np.testing.assert_array_equal(meshed["best_history"], hist)
    np.testing.assert_array_equal(meshed["batch_scores"],
                                  out["batch_scores"])


def test_chamfer_eval_app_runs(tmp_path, capsys, app_budget_default):
    pytest.importorskip("matplotlib")
    png = tmp_path / "landscape.png"
    out = chamfer_eval.main(["--device", "cpu", "--poses", "150",
                             "--points", "96", "--plot", str(png)])
    text = capsys.readouterr().out
    assert "corr(chamfer, trans_err)" in text and png.stat().st_size > 1000
    assert out["chamfer"].shape == (150,) and out["corr_trans"] > 0.3

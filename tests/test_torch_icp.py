"""The port's registration slice against the JAX package on the CPU:
umeyama, iterative_closest_point, register_batch, evaluate_registration,
icp_cpu_reference, the chunked nearest-neighbour and chamfer pair, the
port's create_register_data by its properties, the 3x3 SVD's plain
version (ops/cuda_svd3.py, the kernel's arithmetic) against
torch.linalg.svd, and the icp_registration app.

The registration data is JAX's create_register_data output (4 objects of
200 points, uncropped, and cropped 0.3 with noise 0.005), given to both
packages as numpy arrays. Tolerances: umeyama within 1e-5; after 30 ICP
steps R and t within 1e-4 and rmse within 1e-5 (both compute the same
float32 distances, matched points and 3x3 SVDs; torch.linalg.svd and
JAX's are LAPACK both). On the uncropped clouds ICP recovers the pose
exactly, and each package's rmse is the float32 floor of the expansion
|x|^2 + |y|^2 - 2<x, y> (about 1e-4, the square root of a sum of rounding
errors, which no two summation orders share): there the mean squared
distance (rmse^2) is held within 4 * eps * max|x|^2 instead. converged
equal. The plain 3x3 SVD: singular values within 1e-5 of the largest,
u diag(s) vt within 1e-5 of the input, u and vt orthogonal within 1e-6,
and the Umeyama rotation u D vt within 1e-5 of torch.linalg.svd's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_renderer_tpu.ops import icp as jicp
from torch_renderer_tpu.ops import knn_chamfer as jknn
from torch_renderer_tpu.ops.icosphere import icosphere as jicosphere
from torch_renderer_tpu.opt import registration as jreg
from torch_renderer_tpu_torch.apps import icp_registration
from torch_renderer_tpu_torch.ops import cuda_svd3, icp, knn_chamfer
from torch_renderer_tpu_torch.opt import registration as reg
from torch_renderer_tpu_torch.rasterize.binning import (
    set_budget_check_default,
)

ITERS = 30
EPS32 = float(np.finfo(np.float32).eps)
CASES = {"uncropped": dict(crop_fraction=0.0, noise_std=0.0),
         "cropped": dict(crop_fraction=0.3, noise_std=0.005)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cloud():
    """tests/test_pose_search.py's asymmetric cloud (a squashed icosphere
    with a lobe) on the level-3 icosphere, 200 of its points (a seeded
    choice)."""
    verts, _ = jicosphere(3)
    pts = verts * np.array([1.0, 0.6, 0.3], np.float32)
    pts[:160] += np.array([0.8, 0.0, 0.0], np.float32)
    return pts[np.random.default_rng(0).permutation(len(pts))[:200]]


_JAX_ICP = jax.jit(lambda d: jreg.register_batch(d, max_iterations=ITERS))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    cfg = jreg.RegisterDataConfig(n_objects=4, translation_std=0.05,
                                  max_angle=0.3, **CASES[request.param])
    data = jreg.create_register_data(jax.random.PRNGKey(3),
                                     jnp.asarray(_cloud()), cfg)
    sol = _JAX_ICP(data)
    data_np = {k: np.asarray(v) for k, v in data.items()}
    torch_data = {k: torch.tensor(v) for k, v in data_np.items()}
    return request.param, data_np, torch_data, sol


def _close(ours, theirs, tol):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("estimate_scale", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_umeyama_matches_jax(estimate_scale, weighted):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(5, 64, 3)).astype(np.float32)
    Y = (1.3 * X @ np.diag([1.0, -1.0, -1.0]).astype(np.float32)
         + 0.2 + 0.01 * rng.normal(size=X.shape)).astype(np.float32)
    w = rng.uniform(0.0, 1.0, size=(5, 64)).astype(np.float32) \
        if weighted else None
    ours = icp.umeyama(torch.tensor(X), torch.tensor(Y),
                       None if w is None else torch.tensor(w),
                       estimate_scale)
    theirs = jicp.umeyama(X, Y, w, estimate_scale)
    for a, b in zip(ours, theirs):
        _close(a, b, 1e-5)


def test_icp_matches_jax(case):
    name, data, td, sol = case
    ours = icp.iterative_closest_point(td["source"], td["target"],
                                       y_mask=td["target_mask"],
                                       max_iterations=ITERS)
    _close(ours.RTs.R, sol.RTs.R, 1e-4)
    _close(ours.RTs.t, sol.RTs.t, 1e-4)
    _close(ours.t_history, sol.t_history, 1e-4)
    _close(ours.Xt, sol.Xt, 1e-4)
    if name == "uncropped":
        floor = 4 * EPS32 * float((data["target"] ** 2).sum(-1).max())
        _close(ours.rmse ** 2, np.asarray(sol.rmse) ** 2, floor)
        assert float(ours.rmse.max()) < 1e-3
    else:
        _close(ours.rmse, sol.rmse, 1e-5)
        _close(ours.rmse_history, sol.rmse_history, 1e-5)
    np.testing.assert_array_equal(ours.converged.numpy(),
                                  np.asarray(sol.converged))


def test_register_batch_and_evaluation_match_jax(case):
    name, data, td, sol = case
    ours = reg.register_batch(td, max_iterations=ITERS)
    m = reg.evaluate_registration(ours, td["gt_R"], td["gt_t"])
    mj = jreg.evaluate_registration(sol, data["gt_R"], data["gt_t"])
    assert set(m) == set(mj)
    for k in ("trans_err", "mean_trans_err", "rot_err", "mean_rot_err"):
        _close(m[k], mj[k], 1e-4)
    np.testing.assert_array_equal(m["converged"].numpy(),
                                  np.asarray(mj["converged"]))
    if name == "uncropped":
        # tests/test_pose_search.py's exact-recovery gates
        assert float(m["mean_trans_err"]) < 1e-3
        assert float(m["mean_rot_err"]) < 1e-2


def test_icp_with_init_and_scale_matches_jax(case):
    _, data, td, _ = case
    rng = np.random.default_rng(1)
    init = jicp.SimilarityTransform(
        R=np.broadcast_to(np.eye(3, dtype=np.float32), (4, 3, 3)),
        t=(0.02 * rng.normal(size=(4, 3))).astype(np.float32),
        s=np.full((4,), 0.95, np.float32))
    theirs = jicp.iterative_closest_point(
        data["source"], data["target"], y_mask=data["target_mask"],
        init_transform=init, max_iterations=10, estimate_scale=True)
    ours = icp.iterative_closest_point(
        td["source"], td["target"], y_mask=td["target_mask"],
        init_transform=icp.SimilarityTransform(
            *(torch.tensor(np.array(x)) for x in init)),
        max_iterations=10, estimate_scale=True)
    for a, b in zip(ours.RTs, theirs.RTs):
        _close(a, b, 1e-4)


def test_icp_static_loop_equals_plain_loop(case):
    """The loop's in-place state, device counter and history buffers
    (what a captured step needs) against a plain Python loop of the same
    step: equal bit for bit on the CPU."""
    _, _, td, _ = case
    X, Y, ym = td["source"], td["target"], td["target_mask"]
    ours = icp.iterative_closest_point(X, Y, y_mask=ym, max_iterations=12)
    B, N, _ = X.shape
    R, t, s = torch.eye(3).expand(B, 3, 3), torch.zeros(B, 3), torch.ones(B)
    ts = []
    for _ in range(12):
        d2, idx = knn_chamfer.nn_points(icp._apply(R, t, s, X), Y, None, ym)
        matched = Y.gather(1, idx[..., None].expand(B, N, 3))
        R, t, s = icp.umeyama(X, matched, torch.ones(B, N))
        ts.append(t)
    assert torch.equal(ours.RTs.R, R) and torch.equal(ours.RTs.t, t)
    assert torch.equal(ours.t_history, torch.stack(ts))


def test_capture_on_cpu_raises(case):
    _, _, td, _ = case
    with pytest.raises(ValueError, match="capture=True"):
        reg.register_batch(td, max_iterations=2, capture=True)


def test_icp_cpu_reference_equals_jax(case):
    _, data, _, _ = case
    for b in range(2):
        ours = reg.icp_cpu_reference(data["source"][b], data["target"][b],
                                     max_iterations=20)
        theirs = jreg.icp_cpu_reference(data["source"][b],
                                        data["target"][b],
                                        max_iterations=20)
        for a, c in zip(ours, theirs):
            np.testing.assert_array_equal(a, c)


def test_register_batch_matches_cpu_reference():
    """tests/test_pose_search.py's CPU-reference case, on the port's data
    made by JAX's create_register_data(key 4)."""
    cfg = jreg.RegisterDataConfig(n_objects=2, translation_std=0.03,
                                  max_angle=0.2)
    data = jreg.create_register_data(jax.random.PRNGKey(4),
                                     jnp.asarray(_cloud()), cfg)
    td = {k: torch.tensor(np.asarray(v)) for k, v in data.items()}
    sol = reg.register_batch(td, max_iterations=50)
    R_cpu, t_cpu, _ = reg.icp_cpu_reference(
        np.asarray(data["source"][0]), np.asarray(data["target"][0]),
        max_iterations=50)
    _close(sol.RTs.R[0], R_cpu, 1e-3)
    _close(sol.RTs.t[0], t_cpu, 1e-3)


def test_register_batch_sharded_takes_a_mesh():
    """register_batch_sharded takes a DeviceMesh (TypeError for anything
    else) and, on a mesh of one rank, equals register_batch
    (tests/test_torch_parallel.py splits it over 8 ranks)."""
    from torch_renderer_tpu_torch.parallel import make_mesh, run_ranks

    with pytest.raises(TypeError, match="DeviceMesh"):
        reg.register_batch_sharded({}, object())
    gen = torch.Generator().manual_seed(4)
    data = reg.create_register_data(gen, torch.tensor(_cloud()),
                                    reg.RegisterDataConfig(n_objects=3))
    plain = reg.register_batch(data, max_iterations=10)
    [sharded] = run_ranks(lambda: reg.register_batch_sharded(
        data, make_mesh((1, 1)), max_iterations=10), 1, "gloo")
    for name in ("converged", "rmse", "Xt", "t_history", "rmse_history"):
        assert torch.equal(getattr(plain, name), getattr(sharded, name))
    assert all(torch.equal(a, b) for a, b in zip(plain.RTs, sharded.RTs))


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("chunk", [7, 64, 4096])
def test_chunked_nn_and_chamfer_equal_dense(masks, chunk):
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(3, 50, 3)).astype(np.float32))
    y = torch.tensor(rng.normal(size=(3, 40, 3)).astype(np.float32))
    xm = torch.tensor((rng.uniform(size=(3, 50)) > 0.3).astype(np.float32)) \
        if masks else None
    ym = torch.tensor((rng.uniform(size=(3, 40)) > 0.3).astype(np.float32)) \
        if masks else None
    d, i = knn_chamfer.nn_points_chunked(x, y, xm, ym, chunk=chunk)
    dd, ii = knn_chamfer.nn_points(x, y, xm, ym)
    assert torch.equal(d, dd) and torch.equal(i, ii)
    for red in ("mean", "sum", None):
        c, _ = knn_chamfer.chamfer_distance_chunked(x, y, xm, ym, red, chunk)
        cd, _ = knn_chamfer.chamfer_distance(x, y, xm, ym, red)
        torch.testing.assert_close(c, cd, rtol=0, atol=0)
    cj, _ = jknn.chamfer_distance_chunked(
        x.numpy(), y.numpy(), None if xm is None else xm.numpy(),
        None if ym is None else ym.numpy(), None, chunk)
    _close(c, cj, 1e-6)


@pytest.mark.parametrize("crop", [0.0, 0.3])
def test_create_register_data_properties(crop):
    """The port's own data (its random stream is torch's): target = R
    source + t up to the noise, the crop keeps its share, angles within
    max_angle."""
    cfg = reg.RegisterDataConfig(n_objects=16, translation_std=0.05,
                                 max_angle=0.3, crop_fraction=crop,
                                 noise_std=0.01 if crop else 0.0)
    base = torch.tensor(_cloud())
    data = reg.create_register_data(torch.Generator().manual_seed(5), base,
                                    cfg)
    assert data["source"].shape == data["target"].shape == (16, 200, 3)
    assert torch.equal(data["source"][3], base)
    R, t = data["gt_R"], data["gt_t"]
    torch.testing.assert_close(R @ R.transpose(1, 2),
                               torch.eye(3).expand(16, 3, 3), atol=1e-5,
                               rtol=0)
    angle = torch.arccos(((R.diagonal(dim1=1, dim2=2).sum(-1) - 1) / 2)
                         .clamp(-1, 1))
    assert float(angle.max()) <= 0.3 + 1e-3
    moved = torch.einsum("bij,bpj->bpi", R, data["source"]) + t[:, None]
    resid = (data["target"] - moved).abs().max()
    if crop:
        assert 0.0 < float(resid) < 0.01 * 6
        keep = data["target_mask"].mean(-1)
        assert ((keep - (1 - crop)).abs() <= 1.0 / 200 + 1e-6).all()
    else:
        assert float(resid) < 1e-6
        assert bool((data["target_mask"] == 1).all())


def _covariances(kind: str, n: int = 64):
    rng = np.random.default_rng({"random": 6, "rank2": 7, "reflected": 8}[
        kind])
    A = rng.normal(size=(n, 3, 3))
    if kind == "rank2":
        U, S, Vt = np.linalg.svd(A)
        S[:, 2] = 0.0
        A = U * S[:, None, :] @ Vt
    elif kind == "reflected":
        # distinct singular values, det(U Vt) = -1: the Umeyama rotation
        # needs its reflection fix
        U, _, Vt = np.linalg.svd(A)
        U = np.where(np.linalg.det(U @ Vt)[:, None, None] > 0,
                     U * np.array([1.0, 1.0, -1.0]), U)
        A = U * np.array([3.0, 2.0, 0.5]) @ Vt
    return torch.tensor(A.astype(np.float32))


def _umeyama_R(U, Vt):
    det = cuda_svd3.det3(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det),
                     torch.sign(det)], -1)
    return U @ (D[..., None] * Vt)


@pytest.mark.parametrize("kind", ["random", "rank2", "reflected"])
def test_svd3_plain_matches_linalg_svd(kind):
    A = _covariances(kind)
    U, S, Vt = cuda_svd3.svd3_jacobi(A)
    U2, S2, Vt2 = torch.linalg.svd(A)
    scale = float(S2.max())
    _close(S, S2, 1e-5 * scale)
    _close((U * S[:, None, :]) @ Vt, A, 1e-5 * scale)
    eye = torch.eye(3).expand(A.shape[0], 3, 3)
    _close(U.transpose(1, 2) @ U, eye, 1e-6)
    _close(Vt @ Vt.transpose(1, 2), eye, 1e-6)
    _close(_umeyama_R(U, Vt), _umeyama_R(U2, Vt2), 1e-5)
    if kind == "reflected":
        assert bool((cuda_svd3.det3(U @ Vt) < 0).all())


def test_svd3_degenerate_inputs():
    """Zero, rank-1 and already diagonal matrices: u stays orthogonal and
    u diag(s) vt is the input."""
    rng = np.random.default_rng(9)
    A = np.concatenate([np.zeros((1, 3, 3)),
                        rng.normal(size=(4, 3, 1)) @ rng.normal(size=(4, 1, 3)),
                        np.diag([1.0, 3.0, 2.0])[None]]).astype(np.float32)
    A = torch.tensor(A)
    U, S, Vt = cuda_svd3.svd3_jacobi(A)
    _close((U * S[:, None, :]) @ Vt, A, 1e-5)
    _close(U.transpose(1, 2) @ U, torch.eye(3).expand(6, 3, 3), 1e-6)
    _close(S[-1], [3.0, 2.0, 1.0], 0)
    assert bool((S[:, :-1] >= S[:, 1:]).all())


def test_svd3_wrapper_on_cpu_and_det3():
    A = _covariances("random", 8)
    for a, b in zip(cuda_svd3.svd3(A), torch.linalg.svd(A)):
        assert torch.equal(a, b)
    _close(cuda_svd3.det3(A), torch.linalg.det(A), 1e-5)
    with pytest.raises(ValueError):
        cuda_svd3.svd3(A.double())
    with pytest.raises(ValueError):
        cuda_svd3.svd3(torch.zeros(2, 2, 3))


def test_svd3_sweeps_match_kernel_source():
    from pathlib import Path

    src = (Path(cuda_svd3.__file__).parents[1] / "csrc" / "svd3.cu"
           ).read_text()
    assert f"constexpr int kSweeps = {cuda_svd3.SWEEPS};" in src


@pytest.fixture
def app_budget_default():
    """The app sets the process-wide budget-check default for its run; put
    the default (None) back, so later tests in this process see it."""
    yield
    set_budget_check_default(None)


def test_icp_registration_app_runs(capsys, app_budget_default):
    out = icp_registration.main(["--device", "cpu", "--objects", "6",
                                 "--points", "96", "--icp-iters", "20",
                                 "--sweep"])
    text = capsys.readouterr().out
    assert "mean translation err" in text and "n=   5" in text
    assert out["mean_trans_err"] < 1e-3 and out["converged"] == 6
    assert [r["n"] for r in out["sweep"]] == [1, 5]
    # --mesh-shape 1,1: a world of one rank, in this process
    meshed = icp_registration.main(["--device", "cpu", "--objects", "6",
                                    "--points", "96", "--icp-iters", "20",
                                    "--mesh-shape", "1,1"])
    assert "device mesh {'data': 1, 'model': 1}" in capsys.readouterr().out
    np.testing.assert_array_equal(meshed["trans_err"], out["trans_err"])
    assert meshed["converged"] == 6

"""Port parity: so3, look_at, the pose-fit losses and CameraPoseFitter of
torch_renderer_tpu_torch against the JAX package on the CPU, plus short
port fits that must converge and the port's app.

Scene: the pose app's at 64x64 (icosphere(2) normalized to the unit
sphere, 320 faces, so the port bins it; pinhole K at focal scale 0.9;
look_at(2.7, 15, 40)). The JAX fitter runs dense (bin_size=0), the
reference for gradients (tests/test_torch_shading.py says why), with its
soft silhouette kernels in interpret mode on the pallas route.
Tolerances: transforms within 1e-6; loss within 1e-4; loss gradients
within 2e-3 of the largest component.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_renderer_tpu.cameras import look_at as jlook
from torch_renderer_tpu.ops.icosphere import icosphere
from torch_renderer_tpu.opt import pose_fit as jpose
from torch_renderer_tpu.structures.meshes import Meshes
from torch_renderer_tpu.transforms import so3 as jso3
from torch_renderer_tpu_torch import interop
from torch_renderer_tpu_torch.apps import camera_pose_optimizer as app
from torch_renderer_tpu_torch.cameras import look_at as plook
from torch_renderer_tpu_torch.opt import pose_fit as ppose
from torch_renderer_tpu_torch.transforms import so3 as pso3

IMG = 64


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_so3_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    q2 = rng.normal(size=(16, 4)).astype(np.float32)
    pq, jq = torch.from_numpy(q), jnp.asarray(q)
    np.testing.assert_allclose(_np(pso3.quaternion_normalize(pq)),
                               _np(jso3.quaternion_normalize(jq)), atol=1e-6)
    np.testing.assert_allclose(
        _np(pso3.quaternion_multiply(pq, torch.from_numpy(q2))),
        _np(jso3.quaternion_multiply(jq, jnp.asarray(q2))), atol=1e-6)
    Rp = pso3.quaternion_to_matrix(pq)
    np.testing.assert_allclose(_np(Rp), _np(jso3.quaternion_to_matrix(jq)),
                               atol=1e-6)
    # matrix -> quaternion -> matrix round trip, on both sides
    R = _np(Rp)
    qp = pso3.matrix_to_quaternion(torch.from_numpy(R))
    np.testing.assert_allclose(_np(qp),
                               _np(jso3.matrix_to_quaternion(jnp.asarray(R))),
                               atol=1e-6)
    assert (qp[:, 0] >= 0).all()
    np.testing.assert_allclose(_np(pso3.quaternion_to_matrix(qp)), R,
                               atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(dist=2.7, elev=15.0, azim=40.0),
    dict(dist=[2.0, 3.0], elev=[-30.0, 60.0], azim=[10.0, 200.0]),
    dict(dist=2.0, elev=90.0, azim=0.0),              # forward parallel to up
    dict(dist=1.5, elev=20.0, azim=-35.0, at=(0.1, 0.2, -0.3),
         up=(0.0, 0.0, 1.0), inplane_rotation=0.4),
])
def test_look_at_matches_jax(kw):
    Rp, tp = plook.look_at_view_transform(**kw)
    Rj, tj = jlook.look_at_view_transform(**kw)
    np.testing.assert_allclose(_np(Rp), _np(Rj), atol=1e-6)
    np.testing.assert_allclose(_np(tp), _np(tj), atol=1e-6)
    # an orthonormal rotation, and the eye maps to the camera origin
    R = _np(Rp)
    np.testing.assert_allclose(R @ np.swapaxes(R, -1, -2),
                               np.broadcast_to(np.eye(3), R.shape), atol=1e-5)
    eye = _np(plook.camera_position_from_spherical_angles(
        kw["dist"], kw["elev"], kw["azim"]))
    np.testing.assert_allclose(
        _np(eye), _np(jlook.camera_position_from_spherical_angles(
            kw["dist"], kw["elev"], kw["azim"])), atol=1e-6)


def test_losses_and_pose_params_match_jax():
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(2, 3, 8, 8)).astype(np.float32) * 2
    np.testing.assert_allclose(
        _np(ppose.huber_loss(torch.from_numpy(a), torch.from_numpy(b), 0.7)),
        _np(jpose.huber_loss(jnp.asarray(a), jnp.asarray(b), 0.7)), atol=1e-6)
    m1, m2 = (rng.uniform(size=(2, 3, 8, 8)) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        _np(ppose.iou(torch.from_numpy(m1), torch.from_numpy(m2))),
        _np(jpose.iou(jnp.asarray(m1), jnp.asarray(m2))), atol=1e-6)
    R, t = jlook.look_at_view_transform(2.7, 15.0, 40.0)
    pp = ppose.pose_params_from_Rt(_np(R)[0], _np(t)[0], "cpu")
    jp = jpose.pose_params_from_Rt(_np(R)[0], _np(t)[0])
    for k in ("t", "quat"):
        np.testing.assert_allclose(_np(pp[k]), _np(jp[k]), atol=1e-6)
    R2, t2 = ppose.pose_params_to_Rt(interop.pose_params_from_arrays(
        jp["t"], jp["quat"], device="cpu"))
    np.testing.assert_allclose(_np(R2), _np(R), atol=1e-5)
    np.testing.assert_allclose(_np(t2), _np(t), atol=1e-6)


def test_patch_occlusion_zeroes_one_patch():
    img = torch.ones((2, 32, 32))
    out = ppose.patch_occlusion(torch.Generator().manual_seed(0), img,
                                patch_size=8)
    assert out.shape == (2, 32, 32)
    assert ((out == 0).sum((1, 2)) == 64).all()
    again = ppose.patch_occlusion(torch.Generator().manual_seed(0), img, 8)
    assert torch.equal(out, again)


def _scene():
    verts, faces = icosphere(2)
    jm, _, _ = Meshes.from_single(verts, faces).center_and_scale_to_unit_sphere()
    pm = interop.meshes_from_arrays(jm.verts, jm.faces, jm.num_verts,
                                    jm.num_faces, device="cpu")
    K = app.pinhole_K((IMG, IMG))
    R, t = jlook.look_at_view_transform(2.7, 15.0, 40.0)
    return jm, pm, K, _np(R)[0], _np(t)[0]


@pytest.mark.parametrize("route", ["fragments", "pallas"])
def test_fitter_loss_and_gradient_match_jax(route):
    jm, pm, K, R, t = _scene()
    cfg = jpose.PoseFitConfig(use_rgb=True)
    jf = jpose.CameraPoseFitter(K, (IMG, IMG), cfg, silhouette_impl=route,
                                bin_size=0)
    pf = ppose.CameraPoseFitter(K, (IMG, IMG), ppose.PoseFitConfig(
        use_rgb=True), silhouette_impl=route, device="cpu")
    jrefs = jf.make_references(jm, R, t)
    prefs = pf.make_references(pm, R, t)
    for k in ("depth", "sil", "mask", "rgb"):
        # within 1e-4 but at the few pixels where the dense reference breaks
        # a selection-depth tie the other way (another 4th fragment there)
        far = np.abs(_np(prefs[k]) - _np(jrefs[k])) > 1e-4
        assert far.mean() < 2e-3, k
    assert pf.renderer.resolved_settings(pm, R, t).bin_size == 16

    t0 = t + np.float32([0.03, -0.02, 0.05])
    jp = jpose.pose_params_from_Rt(R, t0)
    (jl, jm_), jg = jax.jit(jax.value_and_grad(jf.loss, has_aux=True))(
        jp, jm, jrefs)
    pp = {k: v.clone().requires_grad_(True)
          for k, v in interop.pose_params_from_arrays(
              jp["t"], jp["quat"], device="cpu").items()}
    pl, pmet = pf.loss(pp, pm, prefs)
    pl.backward()
    assert abs(pl.item() - float(jl)) <= 1e-4
    for k in ("loss_sil", "loss_depth", "loss_rgb", "quat_norm", "iou"):
        assert abs(pmet[k].item() - float(jm_[k])) <= 1e-4, k
    gmax = max(float(jnp.abs(jg[k]).max()) for k in ("t", "quat"))
    assert gmax > 0
    for k in ("t", "quat"):
        np.testing.assert_allclose(_np(pp[k].grad), _np(jg[k]),
                                   atol=2e-3 * gmax, err_msg=k)


@pytest.mark.parametrize("route", ["fragments", "pallas"])
def test_port_fit_converges(route):
    """40 Adam steps of a depth + silhouette fit from a perturbed start
    (tests/test_pose_fit.py's protocol, on the binned 320-face scene)."""
    _, pm, K, R, t = _scene()
    fitter = ppose.DepthPoseFitter(
        K, (IMG, IMG), ppose.PoseFitConfig(lr=5e-3, use_rgb=False),
        silhouette_impl=route, device="cpu")
    refs = fitter.make_references(pm, R, t)
    t0 = t + np.float32([0.12, -0.08, 0.15])
    params, hist = fitter.fit(pm, refs,
                              ppose.pose_params_from_Rt(R, t0, "cpu"),
                              n_steps=40)
    losses = _np(hist["loss"])
    assert losses.shape == (40,) and np.isfinite(losses).all()
    assert set(hist) == {"loss", "loss_sil", "loss_depth", "quat_norm",
                         "iou"}
    assert losses[-1] < 0.5 * losses[0]
    err0 = np.linalg.norm(t0 - t)
    err1 = np.linalg.norm(_np(params["t"])[0] - t)
    assert err1 < 0.6 * err0


def test_object_pose_compose_matches_jax():
    rng = np.random.default_rng(3)
    ext = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    for f in range(2):
        R, t = jlook.look_at_view_transform(3.0, 10.0 * f, 30.0 * f)
        ext[f, :3, :3], ext[f, :3, 3] = _np(R)[0], _np(t)[0]
    obj = np.eye(4, dtype=np.float32)
    obj[:3, 3] = rng.normal(size=3) * 0.1
    K = app.pinhole_K((IMG, IMG))
    jf = jpose.ObjectPoseFitter(K, (IMG, IMG), ext)
    pf = ppose.ObjectPoseFitter(K, (IMG, IMG), ext, device="cpu")
    jc = jf.compose(jf.params_from_object_pose(obj))
    pc = pf.compose(pf.params_from_object_pose(obj, "cpu"))
    for k in ("t", "quat"):
        np.testing.assert_allclose(_np(pc[k]), _np(jc[k]), atol=1e-6)
    np.testing.assert_allclose(
        _np(pf.object_pose(pf.params_from_object_pose(obj, "cpu"))), obj,
        atol=1e-6)


@pytest.mark.parametrize("extra", [[], ["--silhouette-impl", "pallas",
                                        "--sil-layout", "packed"]])
def test_app_runs(extra, capsys):
    losses, ious, err0, err1 = app.main(
        ["--device", "cpu", "--iters", "3", "--image-size", "48",
         "--check-budgets", "off"]
        + extra)
    out = capsys.readouterr().out
    assert "translation error" in out and "iters/sec" in out
    assert losses.shape == (3,) and np.isfinite(losses).all()
    assert math.isclose(err0, 0.0666, abs_tol=1e-3)


def test_app_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(["--device", "cuda", "--iters", "1"])

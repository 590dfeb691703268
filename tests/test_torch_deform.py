"""Port parity: the chamfer deformation and the vertex-color fit of
torch_renderer_tpu_torch (opt/deform.py) against the JAX package on the
CPU, and the JAX tests' gates (tests/test_deform.py) on the port.

The deformation loss is compared on the JAX sampler's own draws, fed to the
port's deterministic sampling part. Tolerances: loss terms within 1e-5
relative; the offsets' gradient within 1e-4 of its largest (float32,
nearest neighbours found by another summation order); the color loss within
1e-5 relative and its gradient within 1e-3 of the largest (renders within
1e-4, as tests/test_torch_shading.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_renderer_tpu.ops.icosphere import icosphere
from torch_renderer_tpu.opt import deform as jdeform
from torch_renderer_tpu.structures.meshes import Meshes
from torch_renderer_tpu.structures.textures import TexturesVertex
from torch_renderer_tpu.transforms.so3 import euler_angles_to_matrix
from torch_renderer_tpu_torch import interop
from torch_renderer_tpu_torch.apps import deform_from_pcd as app
from torch_renderer_tpu_torch.ops import sample_points as psp
from torch_renderer_tpu_torch.opt import deform as pdeform

IMAGE = (48, 48)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's fits: the suite runs several
    workers on one machine, where torch's default of one thread per core
    oversubscribes it and the fits slow down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sphere():
    verts, faces = icosphere(2)
    jm = Meshes.from_single(verts, faces)
    pm = interop.meshes_from_arrays(jm.verts, jm.faces, jm.num_verts,
                                    jm.num_faces, device="cpu")
    return jm, pm


def _target(n=800):
    rng = np.random.default_rng(0)
    t = rng.standard_normal((1, n, 3)).astype(np.float32)
    return 0.6 * t / np.linalg.norm(t, axis=-1, keepdims=True)


def test_deform_loss_matches_jax_on_the_same_draws(sphere, monkeypatch):
    jm, pm = sphere
    target = _target()
    cfg = dict(n_samples=400)
    rng = np.random.default_rng(1)
    deform = (0.05 * rng.normal(size=jm.verts.shape)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jd = jdeform.MeshDeformer(jm, target_points=jnp.asarray(target),
                              config=jdeform.DeformConfig(**cfg))
    (_, jmet), jg = jax.value_and_grad(jd.loss, has_aux=True)(
        jnp.asarray(deform), key)

    # the draws jd.loss made: its key split, then the sampler's own
    k_face, k_bary = jax.random.split(jax.random.split(key)[0])
    moved = jm.offset_verts(jnp.asarray(deform))
    areas = moved.face_areas()
    logits = jnp.where(areas > 0, jnp.log(jnp.clip(areas, 1e-30, None)),
                       -jnp.inf)
    face_idx = torch.from_numpy(np.asarray(jax.random.categorical(
        k_face, logits[:, None, :], axis=-1, shape=(1, 400))).astype(np.int64))
    r = torch.from_numpy(np.array(jax.random.uniform(k_bary, (1, 400, 2))))
    monkeypatch.setattr(pdeform, "sample_points_from_meshes",
                        lambda mesh, n, gen: psp.sample_points_at(
                            mesh, face_idx, r))

    pd = pdeform.MeshDeformer(pm, target_points=torch.from_numpy(target),
                              config=pdeform.DeformConfig(**cfg))
    d = torch.from_numpy(deform).requires_grad_(True)
    total, pmet = pd.loss(d)
    total.backward()
    for k in ("loss", "chamfer", "edge", "normal", "laplacian"):
        np.testing.assert_allclose(pmet[k].item(), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    want = np.asarray(jg)
    np.testing.assert_allclose(d.grad.numpy(), want,
                               atol=1e-4 * np.abs(want).max())


def test_deform_to_scaled_target_converges(sphere):
    """The JAX gate: toward a 0.6-radius point target the chamfer falls
    below 0.25x, one snapshot is kept and the mesh shrinks to ~0.6."""
    _, pm = sphere
    cfg = pdeform.DeformConfig(n_samples=400, lr=0.5, momentum=0.9)
    deformer = pdeform.MeshDeformer(
        pm, target_points=torch.from_numpy(_target()), config=cfg)
    mesh, _, hist, snaps = deformer.fit(torch.Generator().manual_seed(0),
                                        n_steps=120, snapshot_every=60)
    cham = hist["chamfer"].numpy()
    assert np.isfinite(hist["loss"].numpy()).all()
    assert cham[-1] < 0.25 * cham[0] and len(snaps) == 1
    radii = mesh.verts[0].norm(dim=-1).numpy()
    assert abs(radii.mean() - 0.6) < 0.1


def test_deform_against_target_mesh(sphere):
    """The JAX gate: a target mesh re-sampled every step."""
    jm, pm = sphere
    target = interop.meshes_from_arrays(0.7 * np.asarray(jm.verts), jm.faces,
                                        jm.num_verts, jm.num_faces,
                                        device="cpu")
    deformer = pdeform.MeshDeformer(
        pm, target_meshes=target,
        config=pdeform.DeformConfig(n_samples=300, lr=0.5))
    _, _, hist, _ = deformer.fit(torch.Generator().manual_seed(1),
                                 n_steps=60)
    cham = hist["chamfer"].numpy()
    assert cham[-1] < 0.5 * cham[0]
    with pytest.raises(ValueError, match="exactly one"):
        pdeform.MeshDeformer(pm)


def _color_scene(jm):
    verts = np.asarray(jm.verts)[0]
    gt_rgb = (0.5 + 0.5 * verts).clip(0, 1).astype(np.float32)
    f = 0.8 * IMAGE[0]
    K = np.array([[f, 0, IMAGE[1] / 2], [0, f, IMAGE[0] / 2], [0, 0, 1]],
                 np.float32)
    angles = np.array([[0.0, a, 0.0] for a in
                       np.linspace(0, 2 * np.pi, 4, endpoint=False)],
                      np.float32)
    Rs = np.array(euler_angles_to_matrix(jnp.asarray(angles)))
    ts = np.tile(np.float32([0.0, 0.0, 3.0]), (4, 1))
    return gt_rgb, K, Rs, ts


def test_vertex_color_loss_matches_jax(sphere):
    jm, pm = sphere
    gt_rgb, K, Rs, ts = _color_scene(jm)
    jf = jdeform.VertexColorFitter(K, IMAGE)
    jgt = dataclasses.replace(jm, textures=TexturesVertex(
        jnp.asarray(gt_rgb)[None]))
    jrefs = jf.make_reference_views(jgt, Rs, ts)
    pf = pdeform.VertexColorFitter(K, IMAGE, device="cpu")
    pgt = dataclasses.replace(pm, textures=interop.textures_vertex_from_arrays(
        gt_rgb[None], device="cpu"))
    prefs = pf.make_reference_views(pgt, torch.from_numpy(Rs),
                                    torch.from_numpy(ts))
    np.testing.assert_allclose(prefs.numpy(), np.asarray(jrefs), atol=1e-4)

    rgb0 = np.random.default_rng(2).uniform(-0.1, 1.1, size=gt_rgb.shape)
    rgb0 = rgb0.astype(np.float32)
    (_, jmet), jg = jax.value_and_grad(jf.loss, has_aux=True)(
        jnp.asarray(rgb0), jm, Rs, ts, jrefs)
    p = torch.from_numpy(rgb0).requires_grad_(True)
    total, pmet = pf.loss(p, pm, torch.from_numpy(Rs), torch.from_numpy(ts),
                          prefs)
    total.backward()
    for k in ("loss", "rgb_mse", "clamp"):
        np.testing.assert_allclose(pmet[k].item(), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    want = np.asarray(jg)
    np.testing.assert_allclose(p.grad.numpy(), want,
                               atol=1e-3 * np.abs(want).max())


def test_vertex_color_fit_recovers_colors(sphere):
    """The JAX gate: fitting vertex RGB from 4 rendered views of a
    known-colored sphere halves the RGB error and keeps colors near
    [0, 1]."""
    jm, pm = sphere
    gt_rgb, K, Rs, ts = _color_scene(jm)
    fitter = pdeform.VertexColorFitter(K, IMAGE,
                                       pdeform.ColorFitConfig(lr=5.0),
                                       device="cpu")
    Rs, ts = torch.from_numpy(Rs), torch.from_numpy(ts)
    gt = dataclasses.replace(pm, textures=interop.textures_vertex_from_arrays(
        gt_rgb[None], device="cpu"))
    refs = fitter.make_reference_views(gt, Rs, ts)
    assert refs.shape == (4, IMAGE[0], IMAGE[1], 3)
    rgb, hist = fitter.fit(pm, Rs, ts, refs, n_steps=80)
    losses = hist["rgb_mse"].numpy()
    assert np.isfinite(losses).all() and losses[-1] < 0.45 * losses[0]
    assert float(rgb.min()) > -0.2 and float(rgb.max()) < 1.2


def test_deform_app_runs(tmp_path, capsys):
    cham = app.main(["--device", "cpu", "--iters", "40", "--level", "2",
                     "--samples", "300", "--snapshot-every", "20",
                     "--out-dir", str(tmp_path)])
    assert "chamfer:" in capsys.readouterr().out
    assert cham[-1] < cham[0]
    assert (tmp_path / "snapshot_000.obj").exists()
    assert (tmp_path / "geometry_result.obj").stat().st_size > 0

"""Port parity: the joint shape + UV-texture fit of torch_renderer_tpu_torch
against the JAX package on the CPU, at the JAX tests' scene
(tests/test_deform_color.py): 48x48, icosphere(2) with sphere UVs, a
squashed target with a striped 64x64 texture, 6 views.

The two packages draw their view subsets from different random streams, so
the loss is compared on one given view_idx, on parameters drawn with numpy.
The JAX side renders dense (bin_size=0): its binned XLA path's silhouette
gradient differs from its own dense one by a few percent (ROADMAP Queue 3),
and the port's binned route matches the dense one. Tolerances: the dataset
images within 1e-4 (as tests/test_torch_shading.py; RGB 2e-4) away from
selection-depth ties; loss terms within 1e-5 relative plus 1e-7; gradients
with respect to deform and texture_map within 2e-3 of the largest (sums in
another order). The fit gates are the JAX tests' own, at their settings and
step count.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_renderer_tpu.ops.icosphere import icosphere
from torch_renderer_tpu.ops.mesh_losses import build_topology
from torch_renderer_tpu.opt import deform_color as jdc
from torch_renderer_tpu.structures.meshes import Meshes
from torch_renderer_tpu.structures.textures import TexturesUV
from torch_renderer_tpu_torch import interop
from torch_renderer_tpu_torch.apps import joint_shape_texture as app
from torch_renderer_tpu_torch.ops.knn_chamfer import chamfer_distance
from torch_renderer_tpu_torch.ops.mesh_losses import (
    build_topology as pbuild_topology,
)
from torch_renderer_tpu_torch.ops.sample_points import (
    sample_points_from_meshes,
)
from torch_renderer_tpu_torch.opt import deform_color as pdc
from torch_renderer_tpu_torch.structures import textures as ptex

IMAGE = (48, 48)
F = 0.9 * IMAGE[0]
K = np.array([[F, 0, IMAGE[1] / 2], [0, F, IMAGE[0] / 2], [0, 0, 1]],
             np.float32)
METRICS = ("loss", "sil_mse", "rgb_mse", "edge", "normal", "laplacian",
           "clamp")


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
def scene():
    verts, faces = icosphere(2)
    uvs = ptex.sphere_uv_mapping(verts)
    tex = np.zeros((64, 64, 3), np.float32)
    tex[:, :, 0] = 0.8
    tex[::8, :, 1] = 0.9
    tv = verts * np.array([1.0, 0.75, 1.0], np.float32)
    jt = Meshes.from_single(tv, faces)
    jt = dataclasses.replace(jt, textures=TexturesUV(
        maps=jnp.asarray(tex)[None], faces_uvs=jt.faces[:1],
        verts_uvs=jnp.asarray(uvs)[None]))
    pt = interop.meshes_from_arrays(
        jt.verts, jt.faces, jt.num_verts, jt.num_faces, device="cpu",
        textures=interop.textures_uv_from_arrays(
            tex[None], faces[None], uvs[None], device="cpu"))
    psrc = interop.meshes_from_arrays(verts[None], faces[None],
                                      [len(verts)], [len(faces)],
                                      device="cpu")
    return verts, faces, uvs, jt, pt, psrc


def _jax_dense_config(**kw):
    return jdc.JointFitConfig(n_views=6, texture_size=64, bin_size=0,
                              max_faces_per_bin=128, active_tiles=0, **kw)


@pytest.fixture(scope="module")
def jax_dataset(scene):
    _, _, _, jt, _, _ = scene
    fitter = jdc.JointShapeTextureFitter(K, IMAGE, _jax_dense_config())
    return {k: np.asarray(v) for k, v in fitter.make_dataset(jt).items()}


@pytest.mark.parametrize("bin_size", [0, 16])
def test_dataset_matches_jax(scene, bin_size):
    """make_dataset against the JAX fitter's. Where the two packages order
    faces at equal selection depth differently (float32 rounding of a
    shared edge's z), shade_k = 2 may shade another face; those pixels are
    held to equal depths instead of equal colors."""
    _, _, _, jt, pt, _ = scene
    jf = jdc.JointShapeTextureFitter(K, IMAGE, _jax_dense_config())
    jds = jf.make_dataset(jt)
    jo = jf.renderer.render(jt.extend(6), jds["R"], jds["t"], with_rgb=True)
    cfg = pdc.JointFitConfig(n_views=6, texture_size=64, bin_size=bin_size)
    pf = pdc.JointShapeTextureFitter(K, IMAGE, cfg, device="cpu")
    ds = pf.make_dataset(pt)
    po = pf.renderer.render(pt.extend(6), ds["R"], ds["t"], with_rgb=True)
    assert torch.equal(po.rgb, ds["rgb"])
    assert ds["rgb"].shape == (6, 48, 48, 3) and ds["sil"].shape == (6, 48, 48)
    assert float(ds["sil"].max()) > 0.9
    for k in ("R", "t", "sil", "depth"):
        np.testing.assert_allclose(ds[k].numpy(), np.asarray(jds[k]),
                                   atol=1e-4, err_msg=k)
    tie = (po.fragments.pix_to_face.numpy()
           != np.asarray(jo.fragments.pix_to_face)).any(-1)
    assert tie.mean() < 0.01
    np.testing.assert_allclose(po.fragments.zbuf.numpy()[tie],
                               np.asarray(jo.fragments.zbuf)[tie], atol=1e-5)
    # 2e-4: the binned route's raster coordinates (tile origin + offset)
    # round blur-band barycentrics differently from the dense ones
    np.testing.assert_allclose(ds["rgb"].numpy()[~tie],
                               np.asarray(jds["rgb"])[~tie], atol=2e-4)


@pytest.mark.parametrize("bin_size,shade_k", [(0, 2), (16, 8)])
def test_joint_loss_and_gradients_match_jax(scene, jax_dataset, bin_size,
                                            shade_k):
    """The loss of one view pair. The dense route runs the default shade_k
    2; the binned route shades all 8 slots, so that faces ordered
    differently at equal depth (see test_dataset_matches_jax) blend to the
    same color."""
    verts, faces, uvs, _, _, psrc = scene
    rng = np.random.default_rng(0)
    deform = (0.03 * rng.normal(size=verts.shape)).astype(np.float32)
    tmap = rng.uniform(-0.1, 1.1, size=(64, 64, 3)).astype(np.float32)
    view_idx = np.array([4, 1])

    jf = jdc.JointShapeTextureFitter(K, IMAGE,
                                     _jax_dense_config(shade_k=shade_k))
    jsrc = Meshes.from_single(verts, faces)
    jds = {k: jnp.asarray(v) for k, v in jax_dataset.items()}
    (_, jm), jg = jax.jit(jax.value_and_grad(jf.loss, has_aux=True))(
        {"deform": jnp.asarray(deform), "texture_map": jnp.asarray(tmap)},
        jsrc, build_topology(jsrc), jnp.asarray(uvs), jds,
        jnp.asarray(view_idx))

    cfg = pdc.JointFitConfig(n_views=6, texture_size=64, bin_size=bin_size,
                             shade_k=shade_k)
    pf = pdc.JointShapeTextureFitter(K, IMAGE, cfg, device="cpu")
    pds = {k: torch.from_numpy(v.copy()) for k, v in jax_dataset.items()}
    pf._ensure_bin_capacity(psrc.extend(6), pds["R"], pds["t"])
    params = {k: v.requires_grad_(True) for k, v in
              interop.joint_params_from_arrays(deform, tmap,
                                               device="cpu").items()}
    total, pm = pf.loss(params, psrc, pbuild_topology(psrc),
                        torch.from_numpy(uvs), pds,
                        torch.from_numpy(view_idx))
    total.backward()
    for k in METRICS:
        np.testing.assert_allclose(pm[k].item(), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert float(jm["clamp"]) > 0 and float(jm["rgb_mse"]) > 0
    for k in ("deform", "texture_map"):
        want = np.asarray(jg[k])
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(params[k].grad.numpy(), want,
                                   atol=2e-3 * np.abs(want).max(),
                                   err_msg=k)


def test_view_schedule_draws_distinct_views():
    pf = pdc.JointShapeTextureFitter(
        K, IMAGE, pdc.JointFitConfig(n_views=6, views_per_step=3),
        device="cpu")
    v = pf.view_schedule(torch.Generator().manual_seed(1), 50)
    assert v.shape == (50, 3) and int(v.min()) >= 0 and int(v.max()) < 6
    assert all(len(set(row.tolist())) == 3 for row in v)
    assert torch.equal(v, pf.view_schedule(
        torch.Generator().manual_seed(1), 50))


def test_auto_bin_size_fit_stays_binned(scene):
    """The JAX gate test_auto_bin_size_fit_stays_binned: with bin_size None
    the fit's own 2-view batch resolves binned settings, and the fit
    runs."""
    _, _, uvs, _, pt, psrc = scene
    cfg = pdc.JointFitConfig(n_views=6, texture_size=64, bin_size=None)
    fitter = pdc.JointShapeTextureFitter(K, IMAGE, cfg, device="cpu")
    ds = fitter.make_dataset(pt)
    _, hist = fitter.fit(psrc, uvs, ds, torch.Generator().manual_seed(0),
                         n_steps=4)
    assert np.isfinite(hist["loss"].numpy()).all()
    two = psrc.extend(2)
    assert fitter.renderer.resolved_settings(
        two, ds["R"][:2], ds["t"][:2]).bin_size == 16


def test_joint_fit_improves_both_losses(scene):
    """The JAX gate test_joint_fit_improves_both_losses, on the port."""
    verts, _, uvs, _, pt, psrc = scene
    cfg = pdc.JointFitConfig(n_views=6, views_per_step=2, texture_size=64,
                             lr_verts=0.3, lr_texture=0.5,
                             lr_decay_steps=100)
    fitter = pdc.JointShapeTextureFitter(K, IMAGE, cfg, device="cpu")
    ds = fitter.make_dataset(pt)
    params, hist = fitter.fit(psrc, uvs, ds, torch.Generator().manual_seed(0),
                              n_steps=200)
    sil, rgb = hist["sil_mse"].numpy(), hist["rgb_mse"].numpy()
    assert sil.shape == (200,) and np.isfinite(hist["loss"].numpy()).all()
    assert sil[-20:].mean() < 0.7 * sil[:20].mean()
    assert rgb[-20:].mean() < 0.7 * rgb[:20].mean()
    final = fitter.textured_mesh(psrc, uvs, params)
    assert isinstance(final.textures, ptex.TexturesUV)
    assert float(final.verts[0, :, 1].max()) < 0.95


def test_default_config_geometry_converges(scene):
    """The JAX gate test_default_config_geometry_converges, on the port:
    the default config keeps the offsets bounded and halves the chamfer
    distance to the target (2000 points each, fixed generator)."""
    verts, _, uvs, _, pt, psrc = scene
    cfg = pdc.JointFitConfig(n_views=6, views_per_step=2, texture_size=64)
    fitter = pdc.JointShapeTextureFitter(K, IMAGE, cfg, device="cpu")
    ds = fitter.make_dataset(pt)
    params, _ = fitter.fit(psrc, uvs, ds, torch.Generator().manual_seed(0),
                           n_steps=200)
    assert float(params["deform"].abs().max()) < 0.5

    def cham(mesh):
        gen = torch.Generator().manual_seed(7)
        a = sample_points_from_meshes(mesh, 2000, gen)
        b = sample_points_from_meshes(pt, 2000, gen)
        return float(chamfer_distance(a, b)[0])

    c0 = cham(psrc)
    c1 = cham(psrc.offset_verts(params["deform"]))
    assert c1 < 0.5 * c0, f"chamfer {c0} -> {c1}"


def test_app_runs(tmp_path, capsys):
    sil, rgb, params = app.main([
        "--device", "cpu", "--iters", "25", "--image-size", "48",
        "--level", "2", "--texture-size", "32", "--views", "6",
        "--check-budgets", "off", "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "sil MSE" in out and "iters/sec" in out
    assert sil.shape == rgb.shape == (25,) and np.isfinite(sil).all()
    assert params["texture_map"].shape == (32, 32, 3)
    for ext in ("obj", "mtl", "png"):
        assert (tmp_path / f"result_colored.{ext}").stat().st_size > 0

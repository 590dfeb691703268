"""Port parity: mesh regularizers, surface sampling and the chamfer distance
of torch_renderer_tpu_torch against the JAX package on the CPU.

Meshes are a perturbed icosphere batch (one mesh padded) from a numpy seed.
Tolerances: topology equal; loss values within 1e-5 relative and vertex
gradients within 1e-5 of the largest (float32, sums in another order);
sampled points within 1e-6 (same draws, same formula); chamfer within 1e-5
relative and nearest-neighbour indices equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_renderer_tpu.ops import knn_chamfer as jknn
from torch_renderer_tpu.ops import mesh_losses as jml
from torch_renderer_tpu.ops import sample_points as jsp
from torch_renderer_tpu.ops.icosphere import icosphere
from torch_renderer_tpu.structures.meshes import Meshes
from torch_renderer_tpu.structures.pointclouds import Pointclouds
from torch_renderer_tpu_torch import interop
from torch_renderer_tpu_torch.ops import knn_chamfer as pknn
from torch_renderer_tpu_torch.ops import mesh_losses as pml
from torch_renderer_tpu_torch.ops import sample_points as psp
from torch_renderer_tpu_torch.structures import pointclouds as ppc

LOSSES = ["mesh_edge_loss", "mesh_laplacian_smoothing",
          "mesh_normal_consistency"]


def _meshes():
    """Two meshes: a perturbed level-2 icosphere and a level-1 one (padded
    to the first's size)."""
    rng = np.random.default_rng(0)
    v2, f2 = icosphere(2)
    v1, f1 = icosphere(1)
    v2 = v2 + 0.05 * rng.normal(size=v2.shape).astype(np.float32)
    v1 = v1 * np.float32([1.0, 0.6, 0.8])
    jm = Meshes.from_lists([v2, v1], [f2, f1])
    pm = interop.meshes_from_arrays(jm.verts, jm.faces, jm.num_verts,
                                    jm.num_faces, device="cpu")
    return jm, pm


def test_topology_matches_jax():
    jm, pm = _meshes()
    jt, pt = jml.build_topology(jm), pml.build_topology(pm)
    for name in ("edges", "num_edges", "adj", "num_adj", "degree"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(jt, name)),
                                      err_msg=name)


@pytest.mark.parametrize("name", LOSSES)
def test_loss_and_vertex_gradient_match_jax(name):
    jm, pm = _meshes()
    jt, pt = jml.build_topology(jm), pml.build_topology(pm)
    jfn, pfn = getattr(jml, name), getattr(pml, name)
    jval, jgrad = jax.value_and_grad(
        lambda v: jfn(Meshes(v, jm.faces, jm.num_verts, jm.num_faces), jt))(
        jm.verts)
    v = pm.verts.clone().requires_grad_(True)
    pval = pfn(pm.update_padded(v), pt)
    pval.backward()
    np.testing.assert_allclose(pval.item(), float(jval), rtol=1e-5)
    jg = np.asarray(jgrad)
    # JAX's norm of the zero normals of padded face pairs (all corners at
    # vertex 0) has a NaN gradient, which the mask does not remove: vertex
    # 0 of the padded mesh. torch's norm has gradient 0 there.
    bad = ~np.isfinite(jg)
    assert [tuple(i) for i in np.argwhere(bad.any(-1))] in ([], [(1, 0)])
    pg = v.grad.numpy()
    assert np.isfinite(pg).all() and np.abs(jg[~bad]).max() > 0
    np.testing.assert_allclose(pg[~bad], jg[~bad],
                               atol=1e-5 * np.abs(jg[~bad]).max())


def test_sample_points_on_the_same_draws():
    """The JAX sampler's own draws (its key split, categorical face choice
    and uniforms) fed to the port's deterministic part give its points."""
    jm, pm = _meshes()
    key = jax.random.PRNGKey(3)
    jpts = np.asarray(jsp.sample_points_from_meshes(jm, 300, key))
    k_face, k_bary = jax.random.split(key)
    areas = jm.face_areas()
    logits = jnp.where((jm.face_mask() > 0) & (areas > 0),
                       jnp.log(jnp.clip(areas, 1e-30, None)), -jnp.inf)
    face_idx = jax.random.categorical(k_face, logits[:, None, :], axis=-1,
                                      shape=(2, 300))
    r = jax.random.uniform(k_bary, (2, 300, 2))
    ppts, pnrm = psp.sample_points_at(
        pm, torch.from_numpy(np.asarray(face_idx).astype(np.int64)),
        torch.from_numpy(np.array(r)), return_normals=True)
    np.testing.assert_allclose(ppts.numpy(), jpts, atol=1e-6)
    assert torch.allclose(pnrm.norm(dim=-1), torch.ones(2, 300), atol=1e-5)


def test_sample_points_from_meshes_draws_on_the_surface():
    """Random draws: every point lies on the (unit) level-1 sphere's
    triangles, padded faces are never chosen, and a seeded generator
    repeats itself."""
    _, pm = _meshes()
    gen = lambda: torch.Generator().manual_seed(11)  # noqa: E731
    a = psp.sample_points_from_meshes(pm, 500, gen())
    b = psp.sample_points_from_meshes(pm, 500, gen())
    assert torch.equal(a, b) and a.shape == (2, 500, 3)
    r = (a[1] / torch.tensor([1.0, 0.6, 0.8])).norm(dim=-1)
    assert float(r.max()) <= 1.0 + 1e-5 and float(r.min()) > 0.8


@pytest.mark.parametrize("masked", [False, True])
def test_chamfer_and_knn_match_jax(masked):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 120, 3)).astype(np.float32)
    y = rng.normal(size=(2, 90, 3)).astype(np.float32)
    nx, ny = np.array([120, 77]), np.array([90, 41])
    xm = (np.arange(120)[None] < nx[:, None]).astype(np.float32)
    ym = (np.arange(90)[None] < ny[:, None]).astype(np.float32)
    jm = (jnp.asarray(xm), jnp.asarray(ym)) if masked else (None, None)
    pm_ = (torch.from_numpy(xm), torch.from_numpy(ym)) if masked \
        else (None, None)
    X, Y = torch.from_numpy(x), torch.from_numpy(y)
    for red in ("mean", "sum", None):
        jc, _ = jknn.chamfer_distance(jnp.asarray(x), jnp.asarray(y), *jm,
                                      batch_reduction=red)
        pc, _ = pknn.chamfer_distance(X, Y, *pm_, batch_reduction=red)
        np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-5)
    jd, ji = jknn.knn_points(jnp.asarray(x), jnp.asarray(y), 4, *jm)
    pd, pi = pknn.knn_points(X, Y, 4, *pm_)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    jcp, _ = jknn.chamfer_pointclouds(
        Pointclouds.from_lists([x[0], x[1, :77]]),
        Pointclouds.from_lists([y[0], y[1, :41]]))
    pcp, _ = pknn.chamfer_pointclouds(
        ppc.Pointclouds.from_lists([x[0], x[1, :77]], device="cpu"),
        ppc.Pointclouds.from_lists([y[0], y[1, :41]], device="cpu"))
    np.testing.assert_allclose(pcp.item(), float(jcp), rtol=1e-5)


def test_chamfer_gradient_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(1, 200, 3)).astype(np.float32)
    y = rng.normal(size=(1, 150, 3)).astype(np.float32)
    jg = np.asarray(jax.grad(lambda a: jknn.chamfer_distance(
        a, jnp.asarray(y))[0])(jnp.asarray(x)))
    X = torch.from_numpy(x).requires_grad_(True)
    pknn.chamfer_distance(X, torch.from_numpy(y))[0].backward()
    np.testing.assert_allclose(X.grad.numpy(), jg,
                               atol=1e-5 * np.abs(jg).max())

"""Port parity: the soft-silhouette public entry (rasterize/soft.py:
soft_silhouette and its three routes, soft_silhouette_binned,
soft_coverage_sum, signed_dist2) against the JAX package on the CPU, where
the port's kernel wrappers run their plain PyTorch versions and the JAX
Pallas kernels run in interpret mode.

The six cases of tests/test_soft.py, each also held against the JAX
function at the same inputs: values within 5e-5 (float32 sums in another
order), vertex gradients within 2e-3 of their largest.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_renderer_tpu as jtrt
import torch_renderer_tpu_torch as port
from torch_renderer_tpu.ops.icosphere import icosphere
from torch_renderer_tpu.rasterize import binning as jbinning
from torch_renderer_tpu.rasterize import geometry as jgeometry
from torch_renderer_tpu.rasterize import soft as jsoft
from torch_renderer_tpu_torch.rasterize import binning as pbinning
from torch_renderer_tpu_torch.rasterize import soft as psoft

SIGMA = 1e-4
H = W = 96
VAL_TOL = 5e-5
GRAD_TOL = 2e-3


def _scenes(level=2, dist=2.7, elev=25.0, azim=40.0):
    """The same mesh and from_fov camera in both packages."""
    v, f = icosphere(level)
    R, t = jtrt.look_at_view_transform(dist, elev, azim)
    jm = jtrt.Meshes.from_single(v, f)
    jc = jtrt.PerspectiveCamera.from_fov(60.0, (H, W), R=R, t=t)
    pm = port.Meshes.from_single(v, f, device="cpu")
    pc = port.PerspectiveCamera.from_fov(60.0, (H, W), R=np.asarray(R),
                                         t=np.asarray(t), device="cpu")
    return jm, jc, pm, pc


@pytest.fixture(scope="module")
def scene():
    return _scenes()


def _close(got, want, tol=VAL_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


# -- the six cases of tests/test_soft.py ------------------------------------

def test_binned_matches_streaming(scene):
    jm, jc, pm, pc = scene
    a_bin = psoft.soft_silhouette(pm, pc, sigma=SIGMA)
    a_str = psoft.soft_silhouette_streaming(pm, pc, sigma=SIGMA,
                                            pixel_chunk=2048, face_chunk=256)
    assert float((a_bin - a_str).abs().max()) < 5e-5
    _close(a_bin, jsoft.soft_silhouette(jm, jc, sigma=SIGMA))


def test_matches_topk_sigmoid_alpha(scene):
    jm, jc, pm, pc = scene
    blur = math.log(1 / 1e-4 - 1) * SIGMA
    settings = port.RasterizationSettings(
        image_size=(H, W), blur_radius=blur, faces_per_pixel=32,
        pixel_chunk=2048)
    frags = port.rasterize_meshes(pm, pc, settings)
    a_topk = port.sigmoid_alpha(frags, SIGMA)
    a_bin = psoft.soft_silhouette(pm, pc, sigma=SIGMA)
    assert float((a_topk - a_bin).abs().max()) < 5e-3
    jfrags = jtrt.rasterize_meshes(jm, jc, jtrt.RasterizationSettings(
        image_size=(H, W), blur_radius=blur, faces_per_pixel=32,
        pixel_chunk=2048))
    _close(a_topk, jtrt.sigmoid_alpha(jfrags, SIGMA))


def test_soft_silhouette_values_sane(scene):
    jm, jc, pm, pc = scene
    a = psoft.soft_silhouette(pm, pc, sigma=SIGMA)[0]
    assert float(a.min()) >= 0 and float(a.max()) <= 1
    assert float(a.max()) > 0.99
    assert float(a[0, 0]) < 1e-3
    cov = float((a > 0.5).float().mean())
    assert 0.05 < cov < 0.9
    _close(a, jsoft.soft_silhouette(jm, jc, sigma=SIGMA)[0])


def test_gradients_finite_and_expand_sphere():
    jm, jc, pm, pc = _scenes(level=1)

    def total(verts):
        return jnp.sum(jsoft.soft_silhouette(jm.update_padded(verts), jc,
                                             sigma=SIGMA))

    want = np.asarray(jax.jit(jax.grad(total))(jm.verts))
    v = pm.verts.clone().requires_grad_(True)
    psoft.soft_silhouette(pm.update_padded(v), pc, sigma=SIGMA).sum() \
        .backward()
    g = v.grad.numpy()
    assert np.isfinite(g).all()
    vn = pm.verts.numpy()[0]
    vn = vn / np.linalg.norm(vn, axis=-1, keepdims=True)
    assert (g[0] * vn).sum() > 0
    _close(g, want, GRAD_TOL * np.abs(want).max())


def test_count_overflow_reports(scene):
    jm, jc, pm, pc = scene
    pad = math.sqrt(psoft.SOFT_CUTOFF * SIGMA)
    fd = port.setup_faces(pm, pc)
    jfd = jgeometry.setup_faces(jm, jc)
    mx, n_over = pbinning.count_overflow(fd, (H, W), 16, 256, pad)
    assert int(mx) <= 256 and int(n_over) == 0
    mx2, n_over2 = pbinning.count_overflow(fd, (H, W), 16, 4, pad)
    assert int(n_over2) > 0
    for cap, got in ((256, (mx, n_over)), (4, (mx2, n_over2))):
        want = jbinning.count_overflow(jfd, (H, W), 16, cap, pad)
        assert tuple(map(int, got)) == tuple(map(int, want))


def test_batched_views_independent():
    v, f = icosphere(2)
    R, t = port.look_at_view_transform(torch.tensor([2.0, 6.0]),
                                       torch.tensor([0.0, 0.0]),
                                       torch.tensor([0.0, 0.0]))
    pm = port.Meshes.from_single(v, f, device="cpu").extend(2)
    pc = port.PerspectiveCamera.from_fov(60.0, (H, W), R=R, t=t)
    a = psoft.soft_silhouette(pm, pc, sigma=SIGMA)
    assert int((a[0] > 0.5).sum()) > 4 * int((a[1] > 0.5).sum())
    jR, jt = jtrt.look_at_view_transform(jnp.asarray([2.0, 6.0]),
                                         jnp.asarray([0.0, 0.0]),
                                         jnp.asarray([0.0, 0.0]))
    jc = jtrt.PerspectiveCamera.from_fov(60.0, (H, W), R=jR, t=jt)
    _close(a, jsoft.soft_silhouette(jtrt.Meshes.from_single(v, f).extend(2),
                                    jc, sigma=SIGMA))


# -- the routes of soft_silhouette --------------------------------------------

@pytest.mark.parametrize("impl", ["auto", "pallas", "binned"])
def test_routes_match_jax(scene, impl):
    """Each route against the JAX function's route of the same name ("auto"
    is the plain route off the card in both packages; "pallas" is the
    kernel pair, its plain versions here, against the Pallas lane kernel
    in interpret mode)."""
    jm, jc, pm, pc = scene
    got = psoft.soft_silhouette(pm, pc, sigma=SIGMA, faces_per_tile=200,
                                impl=impl)
    want = jsoft.soft_silhouette(jm, jc, sigma=SIGMA, faces_per_tile=200,
                                 impl=impl)
    assert tuple(got.shape) == (1, H, W)
    _close(got, want)
    assert float(got.max()) > 0.99


def test_pallas_route_gradient_matches_jax():
    jm, jc, pm, pc = _scenes(level=1)

    def total(verts):
        return jnp.sum(jsoft.soft_silhouette(jm.update_padded(verts), jc,
                                             sigma=SIGMA, impl="pallas"))

    want = np.asarray(jax.jit(jax.grad(total))(jm.verts))
    v = pm.verts.clone().requires_grad_(True)
    psoft.soft_silhouette(pm.update_padded(v), pc, sigma=SIGMA,
                          impl="pallas").sum().backward()
    assert np.abs(want).max() > 0
    _close(v.grad.numpy(), want, GRAD_TOL * np.abs(want).max())


def test_unknown_impl_raises(scene):
    *_, pm, pc = scene
    with pytest.raises(ValueError, match="impl"):
        psoft.soft_silhouette(pm, pc, impl="xla")


# -- the module's other public functions --------------------------------------

@pytest.mark.parametrize("setup", ["faces", "planes"])
def test_binned_and_coverage_sum_match_jax(scene, setup):
    """soft_silhouette_binned and soft_coverage_sum on either face setup,
    against the JAX functions on FaceRasterData; a few faces per tile so
    the budget drops candidates in both."""
    jm, jc, pm, pc = scene
    fd = (port.setup_faces if setup == "faces" else
          port.setup_face_planes)(pm, pc)
    jfd = jgeometry.setup_faces(jm, jc)
    for fpt in (8, 256):
        _close(psoft.soft_silhouette_binned(fd, (H, W), SIGMA, 16, fpt,
                                            tile_chunk=10),
               jsoft.soft_silhouette_binned(jfd, (H, W), SIGMA, 16, fpt))
    S = psoft.soft_coverage_sum(fd, (H, W), SIGMA, pixel_chunk=4000,
                                face_chunk=100).numpy()
    want = np.asarray(jsoft.soft_coverage_sum(jfd, (H, W), SIGMA))
    _close(1.0 - np.exp(-S), 1.0 - np.exp(-want))
    # S itself: a pixel centre on an edge may test inside in one package
    # and outside in the other (edge functions in another form), which
    # moves its S by 2 d2 / sigma for a d2 of float32 rounding size
    np.testing.assert_allclose(S, want, rtol=1e-4, atol=VAL_TOL)


def test_signed_dist2_matches_jax(scene):
    jm, jc, pm, pc = scene
    fd = port.setup_faces(pm, pc)
    jfd = jgeometry.setup_faces(jm, jc)
    pix = psoft.pixel_coords_raster((H, W))[::7]
    pix_h = torch.cat([pix, torch.ones_like(pix[:, :1])], dim=-1)
    got = psoft.signed_dist2(pix_h[None], pix[None], fd.q, fd.abc,
                             fd.area2, fd.valid)
    want = jsoft.signed_dist2(jnp.asarray(pix_h.numpy())[None],
                              jnp.asarray(pix.numpy())[None], jfd.q,
                              jfd.abc, jfd.area2, jfd.valid)
    assert tuple(got.shape) == (1, pix.shape[0], fd.num_faces)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)

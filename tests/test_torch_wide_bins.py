"""Port parity at the bin sizes and K past one kernel block: tiles of 48
and 64 pixels and K above 64, which the JAX package's binned paths run
(its XLA binned path takes any tile and any K). Here the port's kernel
wrappers run their plain PyTorch versions; tests/test_torch_cuda_kernels.py
holds the kernels to them on the card at the same shapes.

Scenes: the mesh raster's of tests/test_torch_raster.py (96^2, 2 views of
a level-2 icosphere, FaceRasterData carried through interop), the point
raster's of tests/test_torch_points.py (64^2, 2 clouds of 400 points), and
the soft entry's of tests/test_torch_soft_entry.py (96^2, one view).

Tolerances, those of the files the scenes come from: mesh face ids differ
only at selection-depth ties (zbuf within 1e-5 there), zbuf and dists
within 1e-5 where they agree, vertex gradients within 2e-3 of the largest.
The ties on under 0.2% of pixels, not 0.1%: at K=4 and blur 1e-4 JAX's own
dense and tile-16 selections differ on 0.114% of this scene's pixels (all
ties, zbuf within 4.8e-7). Barycentrics within 5e-5: a tile's pixel sits
at its origin plus col * (1 / s) in the port (the kernels' formula, which
JAX's Pallas kernels share) and plus col / s on JAX's XLA binned path, and
the two roundings, which grow with the column, move the perspective-
correct barycentrics of faces seen edge-on at the silhouette by up to
2.6e-5 at tile 48 (JAX's own XLA binned path at tile 16 against tile 48:
1.9e-5). At K above 64 the JAX side runs its dense selection (its XLA
binned path compiles for 25 s at K=128 on the CPU; the two select the
same faces up to ties). Point ids equal, zbuf and dists2
within 1e-6; the soft silhouette within 5e-5, its vertex gradient within
2e-3 of the largest. Each JAX function is jitted once per case.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_renderer_tpu as jtrt
from test_torch_points import KW, _pcam, _pcloud, _points
from test_torch_points import K_MAT as PK_MAT
from test_torch_points import H as PH
from test_torch_points import W as PW
from test_torch_raster import H, W, _carry_fd, _carry_settings, _scene
from test_torch_soft_entry import GRAD_TOL, SIGMA, VAL_TOL, _scenes
from torch_renderer_tpu.rasterize.geometry import setup_faces
from torch_renderer_tpu.rasterize.points import (
    PointsRasterizationSettings as JSettings,
)
from torch_renderer_tpu.rasterize.points import rasterize_points as jraster
from torch_renderer_tpu.rasterize.raster import (
    RasterizationSettings,
    rasterize_face_data,
)
from torch_renderer_tpu.rasterize import soft as jsoft
from torch_renderer_tpu.structures.pointclouds import Pointclouds as JClouds
from torch_renderer_tpu_torch import interop
from torch_renderer_tpu_torch.rasterize import raster
from torch_renderer_tpu_torch.rasterize import soft as psoft
from torch_renderer_tpu_torch.rasterize.geometry import (
    setup_faces as psetup_faces,
)
from torch_renderer_tpu_torch.rasterize.points import (
    PointsRasterizationSettings,
    rasterize_points,
)

MESH_FACES = 320   # a level-2 icosphere: every face fits a tile's budget
BARY_TOL = 5e-5
TIE_SHARE = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module, as the suite's other parity
    files: several workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _assert_fragments_match(ours, ref):
    """tests/test_torch_raster.py's check, with TIE_SHARE and BARY_TOL."""
    po, pr = ours.pix_to_face.numpy(), np.asarray(ref.pix_to_face)
    assert po.shape == pr.shape
    zo, zr = ours.zbuf.numpy(), np.asarray(ref.zbuf)
    diff = po != pr
    assert diff.any(-1).mean() < TIE_SHARE, diff.any(-1).mean()
    np.testing.assert_allclose(zo[diff], zr[diff], atol=1e-5)
    same = ~diff
    np.testing.assert_allclose(zo[same], zr[same], atol=1e-5)
    np.testing.assert_allclose(ours.bary.numpy()[same],
                               np.asarray(ref.bary)[same], atol=BARY_TOL)
    np.testing.assert_allclose(ours.dists.numpy()[same],
                               np.asarray(ref.dists)[same], atol=1e-5,
                               rtol=1e-4)


@pytest.fixture(scope="module")
def fd():
    meshes, cam = _scene()
    return setup_faces(meshes, cam)


# tiles of 48 (2304 pixels: blocks of 2 rows for hard_k1, 4 blocks for
# topk_select) and 64 (4096), and K past the old limit of 64 at tile 16
@pytest.mark.parametrize("bin_size,K,blur", [
    (48, 1, 0.0), (48, 2, 1e-4), (48, 4, 1e-4), (64, 1, 0.0), (64, 4, 1e-4),
    (16, 65, 1e-4), (16, 128, 1e-4),
])
def test_wide_mesh_raster_matches_jax(fd, bin_size, K, blur):
    st = RasterizationSettings((H, W), blur_radius=blur, faces_per_pixel=K,
                               bin_size=bin_size,
                               max_faces_per_bin=MESH_FACES)
    jst = st if K <= 4 else dataclasses.replace(st, bin_size=0)
    ref = jax.jit(lambda f: rasterize_face_data(f, jst))(fd)
    ours = raster.rasterize_face_data(_carry_fd(fd), _carry_settings(st))
    assert ours.pix_to_face.shape == (2, H, W, K)
    _assert_fragments_match(ours, ref)
    assert (ours.pix_to_face[..., 0] >= 0).sum() > 1000
    if K > 4:   # some pixel holds more than a few faces in the blur band
        assert int((ours.pix_to_face >= 0).sum(-1).max()) > 4


def test_wide_mesh_gradients_match_jax():
    """Vertex gradients through the tile-64 K=4 raster at blur 0, against
    JAX's binned path at the same settings."""
    meshes, cam = _scene()
    w = np.cos(np.arange(H * W, dtype=np.float32)).reshape(1, H, W, 1)
    pm = interop.meshes_from_arrays(meshes.verts, meshes.faces,
                                    meshes.num_verts, meshes.num_faces,
                                    device="cpu")
    pc = interop.camera_from_arrays(cam.fx, cam.fy, cam.cx, cam.cy, cam.R,
                                    cam.t, cam.image_size, device="cpu")
    st = RasterizationSettings((H, W), faces_per_pixel=4, bin_size=64,
                               max_faces_per_bin=MESH_FACES)

    def terms(fr, where):
        m = fr.pix_to_face >= 0
        return (where(m, fr.zbuf, 0.0) + where(m, fr.dists, 0.0)
                + where(m[..., None], fr.bary, 0.0).sum(-1))

    def jloss(v):
        fr = rasterize_face_data(setup_faces(meshes.update_padded(v), cam),
                                 st)
        return jnp.sum(terms(fr, jnp.where) * w)

    gj = np.asarray(jax.jit(jax.grad(jloss))(meshes.verts))
    v = pm.verts.clone().requires_grad_(True)
    fr = raster.rasterize_face_data(psetup_faces(pm.update_padded(v), pc),
                                    _carry_settings(st))
    (terms(fr, torch.where) * torch.from_numpy(w)).sum().backward()
    assert np.abs(gj).max() > 0
    np.testing.assert_allclose(v.grad.numpy(), gj,
                               atol=GRAD_TOL * np.abs(gj).max())


# tile 64 is the whole 64^2 image; 400 points fit its budget
@pytest.mark.parametrize("bin_size,K", [(64, 4), (16, 65)])
def test_wide_points_match_jax(bin_size, K):
    pts = _points()
    kw = dict(KW, points_per_pixel=K)
    st = JSettings((PH, PW), bin_size=bin_size, max_points_per_bin=512,
                   impl="xla", **kw)
    jcam = jtrt.PerspectiveCamera.from_K(PK_MAT, (PH, PW))
    ref = jax.jit(lambda p: jraster(JClouds.from_padded(p), jcam, st))(
        jnp.asarray(pts))
    ours = rasterize_points(_pcloud(pts), _pcam(),
                            PointsRasterizationSettings(
                                (PH, PW), bin_size=bin_size,
                                max_points_per_bin=512, **kw))
    assert ours.idx.shape == (2, PH, PW, K)
    np.testing.assert_array_equal(ours.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_allclose(ours.zbuf.numpy(), np.asarray(ref.zbuf),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours.dists2.numpy(), np.asarray(ref.dists2),
                               rtol=0, atol=1e-6)
    assert int((ours.idx[..., 0] >= 0).sum()) > 500


def test_wide_soft_silhouette_matches_jax():
    """soft_silhouette(tile=64, impl="pallas"): the kernel pair's plain
    versions at tile 64 against JAX's Pallas route (interpret mode), values
    and vertex gradients."""
    jm, jc, pm, pc = _scenes(level=1)

    def jsil(verts):
        return jsoft.soft_silhouette(jm.update_padded(verts), jc,
                                     sigma=SIGMA, tile=64, impl="pallas")

    want = jax.jit(jsil)(jm.verts)
    gwant = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(jsil(v))))(
        jm.verts))
    v = pm.verts.clone().requires_grad_(True)
    got = psoft.soft_silhouette(pm.update_padded(v), pc, sigma=SIGMA,
                                tile=64, impl="pallas")
    assert tuple(got.shape) == (1, 96, 96)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=VAL_TOL)
    assert float(got.detach().max()) > 0.99
    got.sum().backward()
    assert np.abs(gwant).max() > 0
    np.testing.assert_allclose(v.grad.numpy(), gwant, rtol=0,
                               atol=GRAD_TOL * np.abs(gwant).max())

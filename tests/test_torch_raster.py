"""Port parity: the top-K mesh rasterizer of torch_renderer_tpu_torch (the
plain versions of the hard_k1 and topk_select kernels, the dense path,
autotune) against the JAX package on the CPU.

The scene is tests/test_pallas_hard.py's: 96x96, icosphere(2), B=2, tile
16. The JAX side runs its Pallas kernels in interpret mode. FaceRasterData
and RasterizationSettings are carried across through interop.

Tolerance, from test_pallas_hard.py: face ids differ on under 0.1% of
pixels, and only at selection-depth ties (zbuf equal within 1e-5 there);
zbuf, bary and dists within 1e-5 where the ids agree.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_renderer_tpu as jtrt
from torch_renderer_tpu.ops.icosphere import icosphere
from torch_renderer_tpu.rasterize import autotune as jautotune
from torch_renderer_tpu.rasterize.binning import suggest_active_tiles_fd
from torch_renderer_tpu.rasterize.geometry import setup_faces
from torch_renderer_tpu.rasterize.pallas_hard import rasterize_binned_pallas
from torch_renderer_tpu.rasterize.raster import (
    RasterizationSettings,
    rasterize_face_data,
)
from torch_renderer_tpu_torch import interop
from torch_renderer_tpu_torch.rasterize import autotune, cuda_hard, raster
from torch_renderer_tpu_torch.rasterize.geometry import (
    setup_faces as psetup_faces,
)

H, W = 96, 96
F_PIX = 0.8 * 96
K_MAT = np.array([[F_PIX, 0, W / 2], [0, F_PIX, H / 2], [0, 0, 1]],
                 np.float32)


def _scene(batch=2, level=2):
    verts, faces = icosphere(level)
    meshes = jtrt.Meshes.from_single(verts, faces).extend(batch)
    ts = np.stack([[0.1 * i, -0.05 * i, 2.5 + 0.5 * i]
                   for i in range(batch)]).astype(np.float32)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (batch, 3, 3))
    cam = jtrt.PerspectiveCamera.from_K(K_MAT, (H, W), R=R, t=ts)
    return meshes, cam


def _carry_fd(fd):
    return interop.face_raster_data_from_arrays(
        *(np.asarray(getattr(fd, f.name)) for f in dataclasses.fields(fd)),
        device="cpu")


def _carry_settings(st):
    return interop.raster_settings_from_fields(**dataclasses.asdict(st))


@pytest.fixture(scope="module")
def fd():
    meshes, cam = _scene()
    return setup_faces(meshes, cam)


def _assert_fragments_match(ours, ref, max_diff=1e-3):
    po, pr = ours.pix_to_face.numpy(), np.asarray(ref.pix_to_face)
    assert po.shape == pr.shape
    zo, zr = ours.zbuf.numpy(), np.asarray(ref.zbuf)
    diff = po != pr
    assert diff.any(-1).mean() < max_diff, diff.any(-1).mean()
    np.testing.assert_allclose(zo[diff], zr[diff], atol=1e-5)
    same = ~diff
    np.testing.assert_allclose(zo[same], zr[same], atol=1e-5)
    np.testing.assert_allclose(ours.bary.numpy()[same],
                               np.asarray(ref.bary)[same], atol=1e-5)
    np.testing.assert_allclose(ours.dists.numpy()[same],
                               np.asarray(ref.dists)[same], atol=1e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("K,blur", [(1, 0.0), (1, 1e-4), (2, 1e-4),
                                    (4, 1e-4)])
def test_binned_matches_pallas(fd, K, blur):
    """K=1: hard_k1's plain version against rasterize_binned_pallas
    (_tile_hard); K>1: topk_select's plain version and the re-interpolation
    against rasterize_binned_pallas (_tile_topk_reinterp)."""
    st = RasterizationSettings((H, W), blur_radius=blur, faces_per_pixel=K,
                               bin_size=16, max_faces_per_bin=128)
    ref = rasterize_binned_pallas(fd, st)
    ours = raster.rasterize_face_data(_carry_fd(fd), _carry_settings(st))
    assert ours.pix_to_face.shape == (2, H, W, K)
    assert ours.pix_to_face.dtype == torch.int64
    _assert_fragments_match(ours, ref)
    assert (ours.pix_to_face >= 0).sum() > 1000


@pytest.mark.parametrize("K,blur", [(1, 0.0), (4, 1e-4)])
def test_dense_matches_jax(fd, K, blur):
    st = RasterizationSettings((H, W), blur_radius=blur, faces_per_pixel=K,
                               bin_size=0)
    ref = rasterize_face_data(fd, st)
    ours = raster.rasterize_face_data(_carry_fd(fd), _carry_settings(st))
    _assert_fragments_match(ours, ref)


def test_active_tile_budget_matches_jax(fd):
    """Compaction to a tight active-tile budget drops the same tiles as the
    JAX binned path."""
    act = suggest_active_tiles_fd(fd, (H, W), 16, 0.0, margin=1.0) - 8
    st = RasterizationSettings((H, W), faces_per_pixel=1, bin_size=16,
                               max_faces_per_bin=128, active_tiles=act,
                               impl="xla")
    ref = rasterize_face_data(fd, st)
    ours = raster.rasterize_face_data(_carry_fd(fd), _carry_settings(st))
    _assert_fragments_match(ours, ref)


def test_packed_layout_routes_to_hard_k1(fd, monkeypatch):
    """layout="packed" at K=1 runs hard_k1 (its plain version here) and
    matches the JAX packed-selection path (rasterize_packed_pallas)."""
    calls = []
    wrapped = cuda_hard.hard_k1
    monkeypatch.setattr(cuda_hard, "hard_k1",
                        lambda *a: calls.append(1) or wrapped(*a))
    act = suggest_active_tiles_fd(fd, (H, W), 16, 0.0)
    st = RasterizationSettings((H, W), blur_radius=1e-4, faces_per_pixel=1,
                               bin_size=16, max_faces_per_bin=128,
                               active_tiles=act, layout="packed")
    ref = rasterize_face_data(fd, st)
    ours = raster.rasterize_face_data(_carry_fd(fd), _carry_settings(st))
    _assert_fragments_match(ours, ref)
    assert len(calls) == 1


def test_binned_gradients_match_jax():
    """Vertex gradients through the K=1 and K=4 binned paths against the
    JAX package, within 1e-3 of the largest gradient. The JAX side runs its
    dense path, whose fragments and gradients equal its binned paths'
    (tests/test_pallas_hard.py, test_binned_raster.py), at a fraction of
    the interpret-mode cost."""
    import jax

    meshes, cam = _scene(batch=1, level=1)
    w = np.cos(np.arange(H * W, dtype=np.float32)).reshape(1, H, W, 1)
    pm = interop.meshes_from_arrays(meshes.verts, meshes.faces,
                                    meshes.num_verts, meshes.num_faces,
                                    device="cpu")
    pc = interop.camera_from_arrays(cam.fx, cam.fy, cam.cx, cam.cy, cam.R,
                                    cam.t, cam.image_size, device="cpu")
    for K in (1, 4):
        st = RasterizationSettings((H, W), blur_radius=1e-4,
                                   faces_per_pixel=K, bin_size=16,
                                   max_faces_per_bin=128)

        def jloss(v):
            fr = rasterize_face_data(setup_faces(meshes.update_padded(v),
                                                 cam),
                                     dataclasses.replace(st, bin_size=0))
            m = fr.mask
            val = (jnp.where(m, fr.zbuf, 0.0) + jnp.where(m, fr.dists, 0.0)
                   + jnp.where(m[..., None], fr.bary, 0.0).sum(-1))
            return jnp.sum(val * w[..., :1])

        gj = np.asarray(jax.jit(jax.grad(jloss))(meshes.verts))
        v = pm.verts.clone().requires_grad_(True)
        fr = raster.rasterize_face_data(
            psetup_faces(pm.update_padded(v), pc), _carry_settings(st))
        m = fr.mask
        val = (torch.where(m, fr.zbuf, 0.0) + torch.where(m, fr.dists, 0.0)
               + torch.where(m[..., None], fr.bary, 0.0).sum(-1))
        (val * torch.from_numpy(w)).sum().backward()
        assert np.abs(gj).max() > 0
        np.testing.assert_allclose(v.grad.numpy(), gj,
                                   atol=1e-3 * np.abs(gj).max(),
                                   err_msg=f"K={K}")


def test_autotune_matches_jax():
    """Auto settings resolve to the same tile and budgets as the JAX
    package, at the default margin and at the pose fitters' 2.0."""
    meshes, cam = _scene()
    pm = interop.meshes_from_arrays(meshes.verts, meshes.faces,
                                    meshes.num_verts, meshes.num_faces,
                                    device="cpu")
    pc = interop.camera_from_arrays(cam.fx, cam.fy, cam.cx, cam.cy, cam.R,
                                    cam.t, cam.image_size, device="cpu")
    for blur, K, margin in ((0.0, 1, None), (9.21e-4, 4, 2.0)):
        st = RasterizationSettings((H, W), blur_radius=blur,
                                   faces_per_pixel=K)
        jautotune.clear_cache()
        autotune.clear_cache()
        j = jautotune.resolve_mesh_settings(st, meshes, cam, margin=margin)
        p = autotune.resolve_mesh_settings(_carry_settings(st), pm, pc,
                                           margin=margin)
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
        assert p.bin_size == 16
        # a second call reuses the cache; grow re-measures and keeps it
        assert autotune.resolve_mesh_settings(_carry_settings(st), pm,
                                              pc) is p
    small = RasterizationSettings((H, W))
    assert autotune.resolve_mesh_settings(
        _carry_settings(small), fd=interop.face_raster_data_from_arrays(
            *(np.zeros((1, 80) + s, np.float32) for s in
              ((3, 2), (3,), (3,), (), (3, 3), (3,))),
            np.ones((1, 80), bool), device="cpu")).bin_size == 0
    autotune.clear_cache()
    jautotune.clear_cache()


def test_settings_fields_match_jax():
    jf = [f.name for f in dataclasses.fields(RasterizationSettings)]
    pf = [f.name for f in dataclasses.fields(raster.RasterizationSettings)]
    assert pf == jf
    st = RasterizationSettings((H, W), blur_radius=1e-4, faces_per_pixel=3,
                               bin_size=16, occupancy_split=(4, 32))
    assert dataclasses.asdict(_carry_settings(st)) == dataclasses.asdict(st)
    assert _carry_settings(st).clip_bary == st.clip_bary


@pytest.mark.parametrize("kw,match", [
    (dict(bin_size=64), "bin_size"),
    (dict(bin_size=16, layout="packed", faces_per_pixel=4,
          active_tiles=8), "faces_per_pixel"),
    (dict(bin_size=16, layout="packed"), "active_tiles"),
    (dict(bin_size=16, select_impl="affine", blur_radius=1e-4), "affine"),
    (dict(bin_size=16, select_impl="nope"), "select_impl"),
])
def test_rejected_settings(fd, kw, match):
    st = raster.RasterizationSettings((H, W), **kw)
    with pytest.raises(ValueError, match=match):
        raster.rasterize_face_data(_carry_fd(fd), st)

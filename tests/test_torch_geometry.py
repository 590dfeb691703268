"""Port parity: Meshes, PerspectiveCamera and setup_face_planes of
torch_renderer_tpu_torch against the JAX package, on the CPU.

Inputs are numpy arrays made from a seed (or the icosphere) and handed to
both packages. Tolerance: face planes within 1e-6 (float32 projection; the
3-term rotation sums may round in another order), validity exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_renderer_tpu_torch as port
from torch_renderer_tpu.cameras.perspective import PerspectiveCamera
from torch_renderer_tpu.ops.icosphere import icosphere
from torch_renderer_tpu.rasterize.geometry import setup_face_planes
from torch_renderer_tpu.structures.meshes import Meshes
from torch_renderer_tpu_torch.interop import camera_from_arrays, meshes_from_arrays

IMG = 32
B = 2
POSES = {
    # the packed-soft test scene's two poses (tests/test_packed_soft.py)
    "front": np.array([[0.0, 0.0, 3.0], [0.15, -0.1, 2.6]], np.float32),
    # camera inside the sphere: faces behind it must come out invalid
    "inside": np.array([[0.0, 0.0, 0.5], [0.1, 0.0, -0.2]], np.float32),
}


def _intrinsics():
    f = 0.8 * IMG
    return np.array([[f, 0, IMG / 2], [0, f, IMG / 2], [0, 0, 1]], np.float32)


def _both(pose):
    verts, faces = icosphere(1)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3))
    t = POSES[pose]
    jm = Meshes.from_single(verts, faces).extend(B)
    jc = PerspectiveCamera.from_K(_intrinsics(), (IMG, IMG), R=R, t=t)
    pm = port.Meshes.from_single(verts, faces, device="cpu").extend(B)
    pc = port.PerspectiveCamera.from_K(_intrinsics(), (IMG, IMG), R=R, t=t,
                                       device="cpu")
    return jm, jc, pm, pc


def test_meshes_match_jax():
    rng = np.random.default_rng(0)
    verts = [rng.normal(size=(n, 3)).astype(np.float32) for n in (5, 9)]
    faces = [rng.integers(0, len(v), size=(m, 3)).astype(np.int32)
             for v, m in zip(verts, (4, 7))]
    jm = Meshes.from_lists(verts, faces).extend(3)
    pm = port.Meshes.from_lists(verts, faces, device="cpu").extend(3)
    assert pm.batch_size == jm.batch_size == 6
    assert pm.max_faces == jm.max_faces and pm.max_verts == jm.max_verts
    for name in ("verts", "faces", "num_verts", "num_faces"):
        np.testing.assert_array_equal(getattr(pm, name).numpy(),
                                      np.asarray(getattr(jm, name)))
    np.testing.assert_array_equal(pm.face_mask().numpy(),
                                  np.asarray(jm.face_mask()))
    np.testing.assert_array_equal(pm.vert_mask().numpy(),
                                  np.asarray(jm.vert_mask()))
    # padded faces are (0, 0, 0) and masked out
    assert (pm.faces[0, 4:] == 0).all() and pm.face_mask()[0, 4:].sum() == 0

    new = rng.normal(size=tuple(pm.verts.shape)).astype(np.float32)
    pu = pm.update_padded(torch.from_numpy(new))
    ju = jm.update_padded(jnp.asarray(new))
    np.testing.assert_array_equal(pu.verts.numpy(), np.asarray(ju.verts))
    assert pu.faces is pm.faces


def test_interop_roundtrip():
    jm, jc, pm, pc = _both("front")
    m2 = meshes_from_arrays(jm.verts, jm.faces, jm.num_verts, jm.num_faces,
                            device="cpu").to("cpu")
    for name in ("verts", "faces", "num_verts", "num_faces"):
        assert torch.equal(getattr(m2, name), getattr(pm, name))
    c2 = camera_from_arrays(jc.fx, jc.fy, jc.cx, jc.cy, jc.R, jc.t,
                            jc.image_size, device="cpu").to("cpu")
    assert c2.image_size == pc.image_size == (IMG, IMG)
    for name in ("fx", "fy", "cx", "cy", "R", "t"):
        assert torch.equal(getattr(c2, name), getattr(pc, name))


def test_camera_project_matches_jax():
    """world_to_camera + project, including points at |z| below the signed
    eps clamp on both sides of the camera plane."""
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(B, 64, 3)).astype(np.float32)
    pts[:, :4, 2] = np.array([1e-9, -1e-9, 0.0, -3e-9], np.float32) - 3.0
    jm, jc, pm, pc = _both("front")
    jcam = np.asarray(jc.world_to_camera(jnp.asarray(pts)))
    pcam = pc.world_to_camera(torch.from_numpy(pts))
    np.testing.assert_allclose(pcam.numpy(), jcam, rtol=1e-6, atol=1e-6)
    # project from identical camera-frame points: the clamp is elementwise
    juv, jz = jc.project(jnp.asarray(jcam))
    puv, pz = pc.project(torch.from_numpy(jcam.copy()))
    np.testing.assert_array_equal(pz.numpy(), np.asarray(jz))
    np.testing.assert_allclose(puv.numpy(), np.asarray(juv), rtol=1e-6)
    assert np.isfinite(puv.numpy()).all()
    assert pc.ndc_scale == jc.ndc_scale == IMG / 2


@pytest.mark.parametrize("pose", sorted(POSES))
def test_setup_face_planes_matches_jax(pose):
    jm, jc, pm, pc = _both(pose)
    jfp = setup_face_planes(jm, jc)
    pfp = port.setup_face_planes(pm, pc)
    assert pfp._fields == jfp._fields
    for name in pfp._fields[:-1]:
        np.testing.assert_allclose(getattr(pfp, name).numpy(),
                                   np.asarray(getattr(jfp, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(pfp.valid.numpy(), np.asarray(jfp.valid))
    if pose == "inside":
        assert 0 < pfp.valid.sum() < pfp.valid.numel()

"""Port parity: the rest of the public surface of the structures and cameras
(the Meshes accessors, PerspectiveCamera.from_fov and batch_size, the
pytorch3d pose converters, the cube and quad primitives and the package's
top-level names) against the JAX package, on the CPU. Integer results must
be equal, float32 ones within 1e-6 (the same operations, in float32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_renderer_tpu as jtrt
import torch_renderer_tpu_torch as port
from torch_renderer_tpu.cameras import perspective as jpersp
from torch_renderer_tpu.ops import icosphere as jico
from torch_renderer_tpu_torch.cameras import perspective as ppersp
from torch_renderer_tpu_torch.ops import icosphere as pico
from torch_renderer_tpu_torch.structures.textures import TexturesVertex

TOL = 1e-6


@pytest.fixture(scope="module")
def meshes():
    """Two ragged meshes (a cube and a level-1 icosphere) in both
    packages, with per-vertex colors in the port's."""
    parts = [jico.cube(1.5), jico.icosphere(1)]
    vl, fl = [p[0] for p in parts], [p[1] for p in parts]
    jm = jtrt.Meshes.from_lists(vl, fl)
    feats = np.random.default_rng(0).random((2, jm.max_verts, 3),
                                            dtype=np.float32)
    pm = port.Meshes.from_lists(vl, fl, device="cpu",
                                textures=TexturesVertex(torch.tensor(feats)))
    return jm, pm, feats


def _eq(got, want, tol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


def test_meshes_accessors_match_jax(meshes):
    jm, pm, _ = meshes
    _eq(pm.verts_padded(), jm.verts_padded())
    _eq(pm.faces_padded(), jm.faces_padded())
    _eq(pm.num_verts_per_mesh(), jm.num_verts_per_mesh())
    _eq(pm.num_faces_per_mesh(), jm.num_faces_per_mesh())
    _eq(pm.verts_packed(), jm.verts_packed())
    for got, want in zip(pm.verts_list() + pm.faces_list(),
                         jm.verts_list() + jm.faces_list()):
        _eq(got, want)
    for i in range(2):
        for got, want in zip(pm.get_mesh_verts_faces(i),
                             jm.get_mesh_verts_faces(i)):
            _eq(got, want)
    assert pm.verts_packed().shape == (int(pm.num_verts.sum()), 3)


def test_meshes_bounding_boxes_and_scale_match_jax(meshes):
    jm, pm, _ = meshes
    _eq(pm.bounding_boxes(), jm.bounding_boxes(), TOL)
    assert tuple(pm.bounding_boxes().shape) == (2, 3, 2)
    centre = np.array([0.1, -0.2, 0.3], np.float32)
    _eq(pm.scale(2.5).verts, jm.scale(2.5).verts, TOL)
    _eq(pm.scale(0.5, torch.tensor(centre)).verts,
        jm.scale(0.5, jnp.asarray(centre)).verts, TOL)
    # padded vertices stay zero
    assert float(pm.scale(3.0, torch.tensor(centre)).verts[0, 8:]
                 .abs().max()) == 0.0


@pytest.mark.parametrize("idx", [1, slice(0, 1), slice(None, None, -1),
                                 [1, 0]])
def test_meshes_getitem_matches_jax(meshes, idx):
    jm, pm, feats = meshes
    got = pm[idx]
    want = jm[np.asarray(idx) if isinstance(idx, list) else idx]
    for name in ("verts", "faces", "num_verts", "num_faces"):
        _eq(getattr(got, name), getattr(want, name))
    jidx = slice(idx, idx + 1) if isinstance(idx, int) else idx
    _eq(got.textures.verts_features, feats[jidx])
    assert got.textures.verts_features.shape[0] == got.batch_size
    assert got.batch_size == want.batch_size


def test_cameras_from_fov_match_jax():
    R, t = jtrt.look_at_view_transform(jnp.asarray([2.0, 3.0]),
                                       jnp.asarray([10.0, 20.0]),
                                       jnp.asarray([0.0, 45.0]))
    for fov, size, Rt in ((60.0, (96, 96), None), (45.0, (48, 80), (R, t))):
        kw = {} if Rt is None else dict(R=np.asarray(Rt[0]),
                                        t=np.asarray(Rt[1]))
        want = jtrt.PerspectiveCamera.from_fov(fov, size, **kw)
        got = port.PerspectiveCamera.from_fov(fov, size, device="cpu", **kw)
        for name in ("fx", "fy", "cx", "cy", "R", "t"):
            _eq(getattr(got, name), getattr(want, name), TOL)
        assert got.image_size == want.image_size
        assert got.batch_size == want.batch_size
        _eq(got.K(), want.K(), TOL)
    # a tensor R decides the device, as K does for from_K
    cam = port.PerspectiveCamera.from_fov(60.0, (8, 8), R=torch.eye(3))
    assert cam.fx.device.type == "cpu"


def test_batch_size_matches_jax():
    K = np.eye(3, dtype=np.float32)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (3, 3, 3))
    assert port.PerspectiveCamera.from_K(K, (8, 8), R=R, device="cpu") \
        .batch_size == jtrt.PerspectiveCamera.from_K(K, (8, 8), R=R) \
        .batch_size == 3


def test_pose_converters_match_jax(rng):
    from scipy.spatial.transform import Rotation

    R = Rotation.random(5, rng).as_matrix().astype(np.float32)
    t = rng.normal(size=(5, 3)).astype(np.float32)
    Rp, Tp = ppersp.pose_opencv_to_pytorch3d(torch.tensor(R),
                                             torch.tensor(t))
    jRp, jTp = jpersp.pose_opencv_to_pytorch3d(jnp.asarray(R),
                                               jnp.asarray(t))
    _eq(Rp, jRp)
    _eq(Tp, jTp)
    R2, t2 = ppersp.pose_pytorch3d_to_opencv(Rp, Tp)
    jR2, jt2 = jpersp.pose_pytorch3d_to_opencv(jRp, jTp)
    _eq(R2, jR2)
    _eq(t2, jt2)
    # the round trip of tests/test_cameras.py
    _eq(R2, R, TOL)
    _eq(t2, t, TOL)


def test_pytorch3d_convention_semantics(rng):
    """tests/test_cameras.py's check: the converted pose maps world points
    to the same camera coordinates up to diag(-1, -1, 1)."""
    R_cv, t_cv = port.look_at_opencv(torch.tensor([[0.3, 1.0, -2.0]]))
    Rp, Tp = port.pose_opencv_to_pytorch3d(R_cv, t_cv)
    X = torch.tensor(rng.normal(size=(1, 7, 3)), dtype=torch.float32)
    cam_cv = torch.einsum("bij,bpj->bpi", R_cv, X) + t_cv[:, None]
    cam_p3d = torch.einsum("bpj,bji->bpi", X, Rp) + Tp[:, None]
    flip = torch.tensor([-1.0, -1.0, 1.0])
    _eq(cam_p3d, (cam_cv * flip).numpy(), 1e-5)


@pytest.mark.parametrize("name,args", [("cube", ()), ("cube", (2.5,)),
                                       ("quad", ()), ("quad", (0.5, 2.0))])
def test_primitives_match_jax(name, args):
    for got, want in zip(getattr(pico, name)(*args),
                         getattr(jico, name)(*args)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_top_level_names_match_jax():
    """Every name the JAX package exports at the top level for these slices
    is a port function of the same behaviour."""
    names = ["camera_position_from_spherical_angles", "look_at_opencv",
             "look_at_rotation_opencv", "interpolate_face_attributes",
             "sigmoid_alpha", "softmax_rgb_blend", "pose_opencv_to_pytorch3d",
             "pose_pytorch3d_to_opencv", "soft_silhouette"]
    assert set(names) <= set(port.__all__)
    for n in names:
        assert callable(getattr(port, n))
    eye = np.array([[0.3, 1.0, -2.0], [1.0, 0.5, 2.0]], np.float32)
    _eq(port.camera_position_from_spherical_angles(2.0, 30.0, 40.0),
        jtrt.camera_position_from_spherical_angles(2.0, 30.0, 40.0), TOL)
    _eq(port.look_at_rotation_opencv(eye), jtrt.look_at_rotation_opencv(eye),
        TOL)
    for got, want in zip(port.look_at_opencv(eye), jtrt.look_at_opencv(eye)):
        _eq(got, want, TOL)

    # the fragment and blending names on seeded fragments (K=3, two empty
    # slots a pixel at most)
    g = np.random.default_rng(1)
    shape = (2, 4, 5, 3)
    p2f = np.where(g.random(shape) < 0.3, -1, g.integers(0, 6, size=shape))
    bary = g.dirichlet(np.ones(3), size=shape).astype(np.float32)
    zbuf = g.uniform(1.5, 3.0, size=shape).astype(np.float32)
    dists = g.normal(scale=1e-4, size=shape).astype(np.float32)
    attrs = g.normal(size=(2, 6, 3, 3)).astype(np.float32)
    colors = g.random(shape + (3,), dtype=np.float32)
    pf = port.Fragments(torch.tensor(p2f), torch.tensor(zbuf),
                        torch.tensor(bary), torch.tensor(dists))
    jf = jtrt.Fragments(jnp.asarray(p2f, jnp.int32), jnp.asarray(zbuf),
                        jnp.asarray(bary), jnp.asarray(dists))
    _eq(port.interpolate_face_attributes(pf.pix_to_face, pf.bary,
                                         torch.tensor(attrs)),
        jtrt.interpolate_face_attributes(
            jf.pix_to_face, jf.bary, jnp.asarray(attrs)), 1e-5)
    _eq(port.sigmoid_alpha(pf, 1e-4), jtrt.sigmoid_alpha(jf, 1e-4), TOL)
    _eq(port.softmax_rgb_blend(torch.tensor(colors), pf, port.BlendParams()),
        jtrt.softmax_rgb_blend(jnp.asarray(colors), jf, jtrt.BlendParams()),
        1e-5)

"""The port's scene assembly (structures/scenes.py), G-buffer decodes
(shading/gbuffer.py), phong.face_shading_attrs and the nearest-neighbour
color transfer (ops/color_transfer.py) against the JAX package's, on the
same numpy inputs.

Scene assembly is host numpy and must be equal; the sampling helpers must
draw the same positions from the same seed. The decodes run on the same
fragments in both packages: ids and masks equal, normals within 1e-5.
A rendered two-object scene's instance map equals JAX's except at
selection-depth ties (none at this scene).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_renderer_tpu as jtrt
from torch_renderer_tpu.ops import color_transfer as jct
from torch_renderer_tpu.ops.icosphere import cube, icosphere
from torch_renderer_tpu.rasterize.fragments import Fragments as JFragments
from torch_renderer_tpu.shading import gbuffer as jgb
from torch_renderer_tpu.shading import phong as jphong
from torch_renderer_tpu.structures import scenes as jsc
from torch_renderer_tpu.structures.meshes import Meshes as JMeshes
from torch_renderer_tpu.structures.textures import TexturesUV as JTexturesUV
from torch_renderer_tpu_torch import renderer as prenderer
from torch_renderer_tpu_torch.ops import color_transfer as ct
from torch_renderer_tpu_torch.rasterize.fragments import Fragments
from torch_renderer_tpu_torch.shading import gbuffer as gb
from torch_renderer_tpu_torch.shading import phong
from torch_renderer_tpu_torch.structures import scenes as sc
from torch_renderer_tpu_torch.structures.meshes import Meshes
from torch_renderer_tpu_torch.structures.textures import TexturesUV

H, W = 64, 80
F = 60.0
K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pieces(seed=0):
    sv, sf = icosphere(1)
    cv, cf = cube(1.0)
    rng = np.random.default_rng(seed)
    verts = [sv * 0.3 + np.array([-0.45, 0, 2.2], np.float32),
             cv * 0.3 + np.array([0.45, 0, 2.2], np.float32)]
    colors = [rng.uniform(size=v.shape).astype(np.float32) for v in verts]
    return verts, [sf, cf], colors


@pytest.mark.parametrize("pad", [None, (200, 400)])
def test_merge_meshes_matches_jax(pad):
    verts, faces, colors = _pieces()
    kw = {} if pad is None else dict(pad_verts_to=pad[0], pad_faces_to=pad[1])
    got = sc.merge_meshes(verts, faces, colors, [5, 9], device="cpu", **kw)
    ref = jsc.merge_meshes(verts, faces, colors, [5, 9], **kw)
    np.testing.assert_array_equal(got.meshes.verts.numpy(),
                                  np.asarray(ref.meshes.verts))
    np.testing.assert_array_equal(got.meshes.faces.numpy(),
                                  np.asarray(ref.meshes.faces))
    np.testing.assert_array_equal(got.meshes.num_faces.numpy(),
                                  np.asarray(ref.meshes.num_faces))
    np.testing.assert_array_equal(got.face_to_object.numpy(),
                                  np.asarray(ref.face_to_object))
    assert got.face_to_object.dtype == torch.int32
    np.testing.assert_array_equal(
        got.meshes.textures.verts_features.numpy(),
        np.asarray(ref.meshes.textures.verts_features))
    np.testing.assert_array_equal(got.object_categories,
                                  ref.object_categories)
    if pad is not None:
        assert got.meshes.verts.shape[1] == 200
        assert (got.face_to_object[faces[0].shape[0] + faces[1].shape[0]:]
                == -1).all()


def test_merge_meshes_uv_atlas_matches_jax():
    verts, faces, _ = _pieces()
    rng = np.random.default_rng(2)
    uvs = [rng.uniform(size=(v.shape[0], 2)).astype(np.float32) for v in verts]
    atlas = rng.uniform(size=(16, 16, 3)).astype(np.float32)
    got = sc.merge_meshes(verts, faces, None, [1, 2], pad_verts_to=120,
                          pad_faces_to=200, uvs_list=uvs, texture_map=atlas,
                          device="cpu")
    ref = jsc.merge_meshes(verts, faces, None, [1, 2], pad_verts_to=120,
                           pad_faces_to=200, uvs_list=uvs, texture_map=atlas)
    assert isinstance(got.meshes.textures, TexturesUV)
    assert isinstance(ref.meshes.textures, JTexturesUV)
    for name in ("maps", "faces_uvs", "verts_uvs"):
        np.testing.assert_array_equal(
            getattr(got.meshes.textures, name).numpy(),
            np.asarray(getattr(ref.meshes.textures, name)))
    with pytest.raises(ValueError):
        sc.merge_meshes(verts, faces, _pieces()[2], uvs_list=uvs,
                        texture_map=atlas, device="cpu")
    with pytest.raises(ValueError):
        sc.merge_meshes(verts, faces, uvs_list=uvs, device="cpu")


def test_placement_helpers_match_jax():
    sv, _ = icosphere(1)
    R = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    np.testing.assert_array_equal(
        sc.place_on_plane(sv, R, np.array([0.3, -0.2]), 0.1),
        jsc.place_on_plane(sv, R, np.array([0.3, -0.2]), 0.1))
    for seed, n, extent in ((0, 4, 0.5), (1, 5, 0.35), (2, 8, 0.1)):
        a = sc.sample_nonoverlapping_xy(np.random.default_rng(seed), n,
                                        radius=0.12, extent=extent)
        b = jsc.sample_nonoverlapping_xy(np.random.default_rng(seed), n,
                                         radius=0.12, extent=extent)
        np.testing.assert_array_equal(a, b)
    for fn, kw in ((sc.ground_plane, {}), (sc.room_planes, {}),
                   (sc.room_planes, dict(ceiling=True, subdiv=2))):
        for x, y in zip(fn(**kw), getattr(jsc, fn.__name__)(**kw)):
            np.testing.assert_array_equal(x, y)


def test_room_planes_face_inward():
    v, f = sc.room_planes(1.5, 2.5, ceiling=True, subdiv=2)
    assert v.shape == (6 * 9, 3) and f.shape == (6 * 4 * 2, 3)
    ctr = np.array([0.0, 0.0, 1.0])
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    nrm = np.cross(b - a, c - a)
    assert (np.einsum("fi,fi->f", nrm, ctr - (a + b + c) / 3) > 0).all()


def _random_fragments(F_, seed=0, B=2, K_=2):
    rng = np.random.default_rng(seed)
    p2f = rng.integers(-1, F_, (B, H, W, K_)).astype(np.int64)
    bary = rng.uniform(0.05, 1.0, (B, H, W, K_, 3)).astype(np.float32)
    bary /= bary.sum(-1, keepdims=True)
    zbuf = rng.uniform(1, 3, (B, H, W, K_)).astype(np.float32)
    dists = rng.uniform(-1, 1, (B, H, W, K_)).astype(np.float32)
    port = Fragments(*(torch.as_tensor(a) for a in (p2f, zbuf, bary, dists)))
    ref = JFragments(jnp.asarray(p2f.astype(np.int32)), jnp.asarray(zbuf),
                     jnp.asarray(bary), jnp.asarray(dists))
    return port, ref


def test_gbuffer_decodes_match_jax_on_the_same_fragments():
    verts, faces, colors = _pieces()
    scene = sc.merge_meshes(verts, faces, colors, [1, 2], pad_faces_to=300,
                            device="cpu")
    jscene = jsc.merge_meshes(verts, faces, colors, [1, 2], pad_faces_to=300)
    meshes = scene.meshes.extend(2)
    jmeshes = jscene.meshes.extend(2)
    frags, jfrags = _random_fragments(300)
    R, t = jtrt.look_at_view_transform(2.5, 20.0, [10.0, 50.0])
    cam = prenderer.MeshRenderer(K, (H, W), device="cpu").camera_with_pose(
        np.asarray(R), np.asarray(t))
    jcam = jtrt.MeshRenderer(K, (H, W)).camera_with_pose(R, t)
    for space in ("world", "camera"):
        got = gb.render_normals(meshes, frags, cam, space=space).numpy()
        ref = np.asarray(jgb.render_normals(jmeshes, jfrags, jcam,
                                            space=space))
        np.testing.assert_allclose(got, ref, atol=1e-5)
    with pytest.raises(ValueError):
        gb.render_normals(meshes, frags, None, space="camera")
    seg = gb.instance_segmentation(frags, scene.face_to_object)
    assert seg.dtype == torch.int32
    np.testing.assert_array_equal(
        seg.numpy(), np.asarray(jgb.instance_segmentation(
            jfrags, jscene.face_to_object)))
    np.testing.assert_array_equal(
        gb.instance_masks(frags, scene.face_to_object, 3).numpy(),
        np.asarray(jgb.instance_masks(jfrags, jscene.face_to_object, 3)))
    np.testing.assert_allclose(
        gb.visibility_fraction(frags, scene.face_to_object, 3).numpy(),
        np.asarray(jgb.visibility_fraction(jfrags, jscene.face_to_object, 3)),
        atol=1e-7)


def test_rendered_two_object_scene_matches_jax():
    """tests/test_datagen.py's two-sphere scene through both renderers:
    the instance map, masks and camera-space normals."""
    sv, sf = icosphere(1)
    verts = [sv * 0.3 + np.array([-0.45, 0, 2.2], np.float32),
             sv * 0.3 + np.array([0.45, 0, 2.2], np.float32)]
    scene = sc.merge_meshes(verts, [sf, sf], categories=[1, 2], device="cpu")
    jscene = jsc.merge_meshes(verts, [sf, sf], categories=[1, 2])
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    frags, cam = prenderer.MeshRenderer(K, (H, W), device="cpu").rasterize(
        scene.meshes, eye, zero)
    jfrags, jcam = jtrt.MeshRenderer(K, (H, W)).rasterize(jscene.meshes, eye,
                                                          zero)
    seg = gb.instance_segmentation(frags, scene.face_to_object).numpy()[0]
    np.testing.assert_array_equal(
        seg, np.asarray(jgb.instance_segmentation(
            jfrags, jscene.face_to_object))[0])
    assert set(np.unique(seg)) == {-1, 0, 1}
    assert (seg[:, :W // 2] != 1).all() and (seg[:, W // 2:] != 0).all()
    n = gb.render_normals(scene.meshes, frags, cam, space="camera").numpy()[0]
    jn = np.asarray(jgb.render_normals(jscene.meshes, jfrags, jcam,
                                       space="camera"))[0]
    np.testing.assert_allclose(n, jn, atol=1e-5)
    mask = frags.hard_mask().numpy()[0]
    np.testing.assert_allclose(np.linalg.norm(n[mask], axis=-1), 1.0,
                               atol=1e-4)
    assert (n[mask][:, 2] < 0).mean() > 0.9


@pytest.mark.parametrize("textured", [False, True])
@pytest.mark.parametrize("with_points", [True, False])
def test_face_shading_attrs_match_jax(textured, with_points):
    verts, faces, colors = _pieces(3)
    rng = np.random.default_rng(4)
    if textured:
        uvs = [rng.uniform(size=(v.shape[0], 2)).astype(np.float32)
               for v in verts]
        atlas = rng.uniform(size=(8, 8, 3)).astype(np.float32)
        kw = dict(uvs_list=uvs, texture_map=atlas)
        colors = None
    else:
        kw = {}
    got = phong.face_shading_attrs(
        sc.merge_meshes(verts, faces, colors, device="cpu", **kw).meshes,
        with_points=with_points)
    ref = jphong.face_shading_attrs(
        jsc.merge_meshes(verts, faces, colors, **kw).meshes,
        with_points=with_points)
    assert set(got) == set(ref)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-6)


@pytest.mark.parametrize("k", [1, 3])
def test_query_vertex_colors_matches_jax(k):
    rng = np.random.default_rng(k)
    q = rng.standard_normal((2, 40, 3)).astype(np.float32)
    ref_v = rng.standard_normal((2, 60, 3)).astype(np.float32)
    ref_c = rng.uniform(size=(2, 60, 3)).astype(np.float32)
    mask = (rng.uniform(size=(2, 60)) > 0.2).astype(np.float32)
    got = ct.query_vertex_colors(torch.as_tensor(q), torch.as_tensor(ref_v),
                                 torch.as_tensor(ref_c),
                                 ref_mask=torch.as_tensor(mask), k=k)
    want = jct.query_vertex_colors(jnp.asarray(q), jnp.asarray(ref_v),
                                   jnp.asarray(ref_c),
                                   ref_mask=jnp.asarray(mask), k=k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # unbatched inputs gain a batch of 1
    one = ct.query_vertex_colors(torch.as_tensor(q[0]),
                                 torch.as_tensor(ref_v[0]),
                                 torch.as_tensor(ref_c[0]), k=k)
    assert one.shape == (1, 40, 3)


def test_meshes_from_lists_pads_like_jax():
    sv, sf = icosphere(0)
    got = Meshes.from_lists([sv], [sf], device="cpu", pad_verts_to=20,
                            pad_faces_to=30)
    ref = JMeshes.from_lists([sv], [sf], pad_verts_to=20, pad_faces_to=30)
    np.testing.assert_array_equal(got.verts.numpy(), np.asarray(ref.verts))
    np.testing.assert_array_equal(got.faces.numpy(), np.asarray(ref.faces))
    np.testing.assert_array_equal(got.face_mask().numpy(),
                                  np.asarray(ref.face_mask()))

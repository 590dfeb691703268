"""Port parity: textures and the texture-sampling pair of
torch_renderer_tpu_torch against the JAX package on the CPU.

TexturesUV.sample (the plain versions of the CUDA pair) is held against the
JAX gather path and against its Pallas kernel in interpret mode, at the
shapes of tests/test_pallas_texsample.py, on maps and uv drawn with numpy.
Tolerances are that file's: values within 1e-5, map gradients within 1e-4,
uv gradients within 1e-3 (absolute and relative; uv gradients scale with
the map size). The plain backward is held against autograd of the plain
forward within 1e-5 (float32, another summation order). Textured renders
against the JAX MeshRenderer within 1e-4, as tests/test_torch_shading.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_renderer_tpu.cameras.look_at import look_at_view_transform
from torch_renderer_tpu.ops.icosphere import icosphere
from torch_renderer_tpu.renderer import MeshRenderer
from torch_renderer_tpu.structures import textures as jtex
from torch_renderer_tpu.structures.meshes import Meshes
from torch_renderer_tpu_torch import interop
from torch_renderer_tpu_torch import renderer as prenderer
from torch_renderer_tpu_torch.ops import cuda_texsample
from torch_renderer_tpu_torch.structures import textures as ptex

SHAPES = [(64, 64, 3, 1000), (32, 100, 4, 257), (20, 16, 1, 64)]


def _inputs(B, Hm, Wm, C, P, seed=0, uv_shape=None):
    rng = np.random.default_rng(seed)
    maps = rng.uniform(size=(B, Hm, Wm, C)).astype(np.float32)
    uv = rng.uniform(size=(B,) + (uv_shape or (P,)) + (2,)).astype(np.float32)
    return maps, uv


def _jax_sample(maps, uv, method):
    faces_uvs = jnp.zeros((maps.shape[0], 1, 3), jnp.int32)
    verts_uvs = jnp.zeros((maps.shape[0], 3, 2), jnp.float32)

    def loss(m, u):
        s = jtex.TexturesUV(m, faces_uvs, verts_uvs).sample(u, method=method)
        w = jnp.arange(s.size, dtype=jnp.float32).reshape(s.shape)
        return jnp.sum(s * jnp.sin(w)), s

    (_, s), (gm, gu) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(maps), jnp.asarray(uv))
    return np.asarray(s), np.asarray(gm), np.asarray(gu)


def _port_sample(maps, uv, method="auto"):
    m = torch.from_numpy(maps).requires_grad_(True)
    u = torch.from_numpy(uv).requires_grad_(True)
    tex = ptex.TexturesUV(m, torch.zeros((maps.shape[0], 1, 3), dtype=torch.int64),
                          torch.zeros((maps.shape[0], 3, 2)))
    s = tex.sample(u, method=method)
    w = torch.arange(s.numel(), dtype=torch.float32).reshape(s.shape)
    (s * torch.sin(w)).sum().backward()
    return s.detach().numpy(), m.grad.numpy(), u.grad.numpy()


@pytest.mark.parametrize("oracle", ["gather", "pallas"])
@pytest.mark.parametrize("Hm,Wm,C,P", SHAPES)
def test_sample_matches_jax(Hm, Wm, C, P, oracle):
    maps, uv = _inputs(2, Hm, Wm, C, P)
    s_j, gm_j, gu_j = _jax_sample(maps, uv, oracle)
    s_p, gm_p, gu_p = _port_sample(maps, uv)
    np.testing.assert_allclose(s_p, s_j, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(gm_p, gm_j, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(gu_p, gu_j, atol=1e-3, rtol=1e-3)


def test_multidim_points_and_every_method():
    """uv of any leading shape; every method name is one function here."""
    maps, uv = _inputs(2, 16, 16, 3, 0, seed=9, uv_shape=(5, 7))
    s_j, _, _ = _jax_sample(maps, uv, "gather")
    outs = [_port_sample(maps, uv, method)
            for method in ("auto", "gather", "matmul", "pallas")]
    assert outs[0][0].shape == (2, 5, 7, 3)
    np.testing.assert_allclose(outs[0][0], s_j, atol=1e-5, rtol=1e-5)
    for other in outs[1:]:
        for a, b in zip(other, outs[0]):
            np.testing.assert_array_equal(a, b)
    tex = ptex.TexturesUV(torch.from_numpy(maps),
                          torch.zeros((2, 1, 3), dtype=torch.int64),
                          torch.zeros((2, 3, 2)))
    with pytest.raises(ValueError, match="method"):
        tex.sample(torch.from_numpy(uv), method="bilinear")


@pytest.mark.parametrize("Hm,Wm,C,P", SHAPES)
def test_plain_backward_matches_autograd(Hm, Wm, C, P):
    """texsample_bwd_reference against autograd of texsample_fwd_reference;
    corners include the clamped edge rows and columns."""
    rng = np.random.default_rng(3)
    maps = torch.from_numpy(rng.uniform(size=(2, Hm, Wm, C)).astype(np.float32))
    y0 = torch.from_numpy(rng.integers(-1, Hm, size=(2, P)).astype(np.int32))
    x0 = torch.from_numpy(rng.integers(-1, Wm, size=(2, P)).astype(np.int32))
    wy = torch.from_numpy(rng.uniform(size=(2, P)).astype(np.float32))
    wx = torch.from_numpy(rng.uniform(size=(2, P)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, P, C)).astype(np.float32))
    args = [t.clone().requires_grad_(t.is_floating_point())
            for t in (maps, y0, x0, wy, wx)]
    out = cuda_texsample.texsample_fwd_reference(*args)
    want = torch.autograd.grad(out, (args[0], args[3], args[4]), g)
    got = cuda_texsample.texsample_bwd_reference(maps, y0, x0, wy, wx, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_broadcast_map_gradient_sums_views():
    """A map shared by the views through expand: its gradient is the sum of
    the per-view gradients, as with one stacked copy per view."""
    maps, uv = _inputs(1, 12, 10, 3, 50, seed=4)
    base = torch.from_numpy(maps[0]).requires_grad_(True)
    uvt = torch.from_numpy(np.concatenate([uv, uv[:, ::-1]]))
    tex = ptex.TexturesUV(base[None].expand(2, -1, -1, -1),
                          torch.zeros((2, 1, 3), dtype=torch.int64),
                          torch.zeros((2, 3, 2)))
    tex.sample(uvt).square().sum().backward()
    stacked = torch.from_numpy(np.repeat(maps, 2, 0)).requires_grad_(True)
    ptex.TexturesUV(stacked, tex.faces_uvs, tex.verts_uvs).sample(
        uvt).square().sum().backward()
    torch.testing.assert_close(base.grad, stacked.grad.sum(0), rtol=1e-5,
                               atol=1e-6)


def test_wrappers_check_operands():
    maps = torch.zeros((2, 8, 8, 3))
    idx = torch.zeros((2, 5), dtype=torch.int32)
    w = torch.zeros((2, 5))
    with pytest.raises(ValueError, match="int32"):
        cuda_texsample.texsample_fwd(maps, idx.long(), idx, w, w)
    with pytest.raises(ValueError, match="maps"):
        cuda_texsample.texsample_fwd(maps.double(), idx, idx, w, w)
    with pytest.raises(ValueError, match="2x2"):
        cuda_texsample.texsample_fwd(maps[:, :1], idx, idx, w, w)
    with pytest.raises(ValueError, match="g must"):
        cuda_texsample.texsample_bwd(maps, idx, idx, w, w,
                                     torch.zeros((2, 5, 4)))


def test_vertex_features_and_uv_chart_match_jax():
    verts, faces = icosphere(2)
    rng = np.random.default_rng(5)
    feats = rng.uniform(size=(2, len(verts), 3)).astype(np.float32)
    fidx = np.stack([faces, faces[::-1]]).astype(np.int32)
    j = jtex.TexturesVertex(jnp.asarray(feats)).face_features(
        jnp.asarray(fidx))
    p = interop.textures_vertex_from_arrays(feats, device="cpu")
    np.testing.assert_array_equal(
        p.face_features(torch.from_numpy(fidx.astype(np.int64))).numpy(),
        np.asarray(j))
    np.testing.assert_allclose(ptex.sphere_uv_mapping(verts),
                               np.asarray(jtex.sphere_uv_mapping(verts)),
                               atol=1e-7)
    uvs = ptex.sphere_uv_mapping(verts)
    assert uvs.shape == (len(verts), 2) and uvs.min() >= 0 and uvs.max() <= 1
    jt = jtex.TexturesUV(jnp.zeros((1, 4, 4, 3)), jnp.asarray(faces[None]),
                         jnp.asarray(uvs[None]))
    pt = interop.textures_uv_from_arrays(np.zeros((1, 4, 4, 3)), faces[None],
                                         uvs[None], device="cpu")
    np.testing.assert_array_equal(pt.face_uvs().numpy(),
                                  np.asarray(jt.face_uvs()))
    ext = pt.extend(3)
    assert ext.maps.shape[0] == ext.faces_uvs.shape[0] == 3


@pytest.mark.parametrize("kind", ["uv", "vertex"])
def test_textured_render_matches_jax(kind):
    """A textured icosphere through MeshRenderer (K=4 in the blur band,
    shade_k 2, auto settings: binned on both sides)."""
    verts, faces = icosphere(2)
    rng = np.random.default_rng(6)
    if kind == "uv":
        args = (rng.uniform(size=(1, 32, 32, 3)).astype(np.float32),
                faces[None], jtex.sphere_uv_mapping(verts)[None])
        jt = jtex.TexturesUV(*(jnp.asarray(a) for a in args))
        pt = interop.textures_uv_from_arrays(*map(np.asarray, args),
                                             device="cpu")
    else:
        feats = rng.uniform(size=(1, len(verts), 3)).astype(np.float32)
        jt = jtex.TexturesVertex(jnp.asarray(feats))
        pt = interop.textures_vertex_from_arrays(feats, device="cpu")
    jm = dataclasses.replace(Meshes.from_single(verts, faces), textures=jt)
    pm = interop.meshes_from_arrays(jm.verts, jm.faces, jm.num_verts,
                                    jm.num_faces, textures=pt, device="cpu")
    f = 0.9 * 64
    K = np.array([[f, 0, 32], [0, f, 32], [0, 0, 1]], np.float32)
    R, t = look_at_view_transform(2.7, 10.0, 30.0)
    R, t = np.asarray(R)[0], np.asarray(t)[0]
    kw = dict(faces_per_pixel=4, blur_radius=9.21e-4, shade_k=2)
    jo = MeshRenderer(K, (64, 64), **kw).render(jm, R, t, with_rgb=True)
    po = prenderer.MeshRenderer(K, (64, 64), device="cpu", **kw).render(
        pm, R, t, with_rgb=True)
    assert float(po.rgb.max()) > 0.3
    np.testing.assert_allclose(po.rgb.numpy(), np.asarray(jo.rgb), atol=1e-4)


# ---------------------------------------------------------------------------
# OBJ / MTL / PNG
# ---------------------------------------------------------------------------

def _textured_sphere():
    verts, faces = icosphere(1)
    uvs = ptex.sphere_uv_mapping(verts)
    rng = np.random.default_rng(10)
    image = rng.uniform(-0.1, 1.1, size=(16, 24, 3)).astype(np.float32)
    return verts, faces, uvs, image


def test_save_obj_writes_the_jax_files(tmp_path):
    """OBJ and MTL byte for byte as the JAX save_obj writes them; the PNG
    decodes to the same pixels (when PIL is importable)."""
    from torch_renderer_tpu.io import obj as jobj
    from torch_renderer_tpu_torch.io import obj as pobj

    verts, faces, uvs, image = _textured_sphere()
    rgb = np.random.default_rng(11).uniform(size=verts.shape)
    for pkg, sub in ((jobj, "jax"), (pobj, "port")):
        (tmp_path / sub).mkdir()
        pkg.save_obj(str(tmp_path / sub / "m.obj"), verts, faces,
                     verts_uvs=uvs, faces_uvs=faces, texture_image=image)
        pkg.save_obj(str(tmp_path / sub / "c.obj"), verts, faces,
                     verts_rgb=rgb)
    for name in ("m.obj", "m.mtl", "c.obj"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    pytest.importorskip("PIL")
    from PIL import Image

    for sub in ("jax", "port"):
        with Image.open(tmp_path / sub / "m.png") as im:
            assert im.mode == "RGB" and im.size == (24, 16)
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "port" / "m.png")),
        np.asarray(Image.open(tmp_path / "jax" / "m.png")))


def test_obj_round_trip_and_load_matches_jax(tmp_path):
    """save_obj -> load_objs_as_meshes keeps geometry, UVs and (with PIL)
    the 8-bit texture; a quad, negative indices and v//n faces parse as
    the JAX load_obj parses them."""
    from torch_renderer_tpu.io import obj as jobj
    from torch_renderer_tpu_torch.io import obj as pobj

    verts, faces, uvs, image = _textured_sphere()
    path = str(tmp_path / "m.obj")
    pobj.save_obj(path, verts, faces, verts_uvs=uvs, faces_uvs=faces,
                  texture_image=image)
    m = pobj.load_objs_as_meshes([path, path], device="cpu")
    assert m.batch_size == 2
    np.testing.assert_allclose(m.verts[1].numpy(), verts, atol=1e-6)
    np.testing.assert_array_equal(m.faces[0].numpy(), faces)
    try:
        import PIL  # noqa: F401
    except ImportError:
        assert isinstance(m.textures, ptex.TexturesVertex)
    else:
        assert isinstance(m.textures, ptex.TexturesUV)
        np.testing.assert_allclose(m.textures.verts_uvs[0].numpy(), uvs,
                                   atol=1e-6)
        want = (np.clip(image, 0, 1) * 255).astype(np.uint8) / 255.0
        np.testing.assert_allclose(m.textures.maps[0].numpy(), want,
                                   atol=1e-6)
    quad = tmp_path / "q.obj"
    quad.write_text("# quad\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                    "vn 0 0 1\nf 1//1 2//1 3//1 4//1\nf -4 -2 -1\n")
    pq, jq = pobj.load_obj(str(quad)), jobj.load_obj(str(quad))
    np.testing.assert_array_equal(pq.faces, np.asarray(jq.faces))
    np.testing.assert_array_equal(pq.verts, np.asarray(jq.verts))
    assert pq.faces_uvs is None and pq.normals.shape == (1, 3)
    plain = pobj.load_objs_as_meshes([str(quad)], device="cpu")
    assert isinstance(plain.textures, ptex.TexturesVertex)
    assert torch.equal(plain.textures.verts_features, torch.ones(1, 4, 3))

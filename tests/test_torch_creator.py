"""The port's two-phase creator (opt/creator.py) on tests/test_creator.py's
pipeline: an icosphere deformed onto a squashed, vertex-colored target
(300 samples, lr 0.5, 60 steps), then per-vertex RGB fitted from 4 views at
48x48 (lr 5, 40 steps).

The two phases move their losses as the JAX tests' gates say (chamfer to
under half its start; the RGB error finite and falling), the exports
round-trip through OBJ and PLY with colors, and the direct color transfer
equals JAX's ops/color_transfer on the same deformed vertices.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_renderer_tpu.ops import color_transfer as jct
from torch_renderer_tpu.ops.icosphere import icosphere
from torch_renderer_tpu.opt import creator as jcreator
from torch_renderer_tpu_torch.io.ply import load_ply
from torch_renderer_tpu_torch.opt.creator import CreatorConfig, TwoPhaseCreator
from torch_renderer_tpu_torch.opt.deform import ColorFitConfig, DeformConfig
from torch_renderer_tpu_torch.structures.meshes import Meshes
from torch_renderer_tpu_torch.structures.textures import TexturesVertex


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _meshes():
    verts, faces = icosphere(2)
    tgt_verts = (verts * np.array([1.0, 0.7, 0.9], np.float32)).astype(
        np.float32)
    rgb = np.clip(0.5 + 0.5 * tgt_verts, 0, 1).astype(np.float32)
    src = Meshes.from_single(verts, faces, device="cpu")
    target = dataclasses.replace(
        Meshes.from_single(tgt_verts, faces, device="cpu"),
        textures=TexturesVertex(torch.as_tensor(rgb)[None]))
    return src, target


def _config():
    return CreatorConfig(
        geometry=DeformConfig(n_samples=300, lr=0.5, n_steps=60),
        color=ColorFitConfig(lr=5.0, n_steps=40),
        n_color_views=4, image_size=(48, 48))


@pytest.fixture(scope="module")
def pipeline():
    src, target = _meshes()
    creator = TwoPhaseCreator(src, target, _config())
    out1 = creator.geometry_train(torch.Generator().manual_seed(0))
    out2 = creator.color_train()
    return creator, out1, out2


def test_config_matches_jax():
    for f in dataclasses.fields(CreatorConfig):
        if f.name not in ("geometry", "color"):
            assert getattr(CreatorConfig(), f.name) == \
                getattr(jcreator.CreatorConfig(), f.name)


def test_phases_require_order():
    src, target = _meshes()
    fresh = TwoPhaseCreator(src, target, _config())
    with pytest.raises(RuntimeError):
        fresh.color_train()
    with pytest.raises(RuntimeError):
        fresh.transfer_colors()
    with pytest.raises(RuntimeError):
        fresh.export("x.ply")
    jfresh = jcreator.TwoPhaseCreator(None, None, jcreator.CreatorConfig(
        image_size=(48, 48)))
    np.testing.assert_array_equal(fresh.K, jfresh.K)


def test_geometry_phase_halves_chamfer(pipeline):
    _, out1, _ = pipeline
    cham = out1["history"]["chamfer"].numpy()
    assert cham.shape == (60,) and np.isfinite(cham).all()
    assert cham[-1] < 0.5 * cham[0]


def test_color_phase_lowers_rgb_error(pipeline):
    creator, _, out2 = pipeline
    mse = out2["history"]["rgb_mse"].numpy()
    assert mse.shape == (40,) and np.isfinite(mse).all()
    assert mse[-1] < mse[0]
    assert out2["refs"].shape == (4, 48, 48, 3)
    assert creator.verts_rgb.shape == (creator.src.max_verts, 3)


def test_export_roundtrips(pipeline, tmp_path):
    creator, _, _ = pipeline
    creator.export(str(tmp_path / "result.ply"))
    creator.export(str(tmp_path / "result.obj"))
    back = load_ply(str(tmp_path / "result.ply"))
    v, f = creator.deformed.detach_to_lists()[0]
    np.testing.assert_allclose(back["verts"], v, atol=1e-5)
    np.testing.assert_array_equal(back["faces"], f)
    assert back["colors"] is not None
    assert (tmp_path / "result.obj").stat().st_size > 0


def test_transfer_colors_matches_jax(pipeline):
    creator, _, _ = pipeline
    rgb = creator.transfer_colors().numpy()
    assert rgb.shape == (creator.src.max_verts, 3)
    assert rgb.min() >= 0.0 and rgb.max() <= 1.0
    t = creator.target
    want = np.asarray(jct.query_vertex_colors(
        jnp.asarray(creator.deformed.verts.numpy()),
        jnp.asarray(t.verts.numpy()),
        jnp.asarray(t.textures.verts_features.numpy()),
        ref_mask=jnp.asarray(t.vert_mask().numpy())))[0]
    np.testing.assert_allclose(rgb, want, atol=1e-6)


def test_color_train_needs_vertex_colors():
    src, target = _meshes()
    bare = TwoPhaseCreator(src, dataclasses.replace(target, textures=None),
                           _config())
    bare.deformed = src
    with pytest.raises(ValueError):
        bare.color_train()
    with pytest.raises(ValueError):
        bare.transfer_colors()

"""Port parity: automatic point-rasterization settings of
torch_renderer_tpu_torch (rasterize/autotune.py resolve_points_settings,
PointsRenderer.prepare) against the JAX package on the CPU, and the point
cases of tests/test_auto_settings.py on the port.

The scene is that file's: 2 clouds of 5000 points from N(0, 0.5) at 128x128,
f = 0.8 * 128, t = (0, 0, 3). The resolved settings must equal the JAX
resolver's field for field; auto renders equal the explicit renders they
resolve to and agree with the dense path within 1e-5.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_renderer_tpu as jtrt
import torch_renderer_tpu_torch as port
from torch_renderer_tpu.rasterize import autotune as jautotune
from torch_renderer_tpu.structures.pointclouds import Pointclouds as JClouds
from torch_renderer_tpu_torch import interop
from torch_renderer_tpu_torch.rasterize import autotune
from torch_renderer_tpu_torch.rasterize.points import (
    PointsRasterizationSettings,
)
from torch_renderer_tpu_torch.structures.pointclouds import Pointclouds



@pytest.fixture
def fresh_cache():
    autotune.clear_cache()
    jautotune.clear_cache()
    yield
    autotune.clear_cache()
    jautotune.clear_cache()


def _auto_cloud(N=5000, seed=0, scale=0.5):
    pts = np.random.RandomState(seed).randn(2, N, 3).astype(np.float32)
    return pts * scale, np.ones((2, N, 3), np.float32)


def _auto_scene():
    f = 0.8 * 128
    K = np.array([[f, 0, 64], [0, f, 64], [0, 0, 1]], np.float32)
    R2 = np.broadcast_to(np.eye(3, dtype=np.float32), (2, 3, 3)).copy()
    t2 = np.tile(np.array([0, 0, 3.0], np.float32), (2, 1))
    return K, R2, t2


@pytest.mark.parametrize("cls,kw", [("AlphaPointRender", dict(radius=0.02)),
                                    ("PulsarRenderer", dict(radius=0.05))])
def test_auto_resolution_matches_jax(fresh_cache, cls, kw):
    """The resolved tile, budgets and guard equal the JAX resolver's; for
    the sphere renderer they are sized against its NDC selection radii."""
    pts, feats = _auto_cloud()
    K, R2, t2 = _auto_scene()
    ours = getattr(port, cls)(K, (128, 128), device="cpu", **kw)
    theirs = getattr(jtrt, cls)(K, (128, 128), **kw)
    st = ours.resolved_settings(interop.pointclouds_from_arrays(
        pts, [5000, 5000], feats, device="cpu"), R2, t2)
    want = theirs.resolved_settings(JClouds.from_padded(
        jnp.asarray(pts), features=jnp.asarray(feats)), R2, t2)
    assert st.bin_size == autotune.AUTO_TILE and st.check_budgets == "warn"
    assert dataclasses.asdict(st) == dataclasses.asdict(want)


def test_auto_matches_explicit_and_dense(fresh_cache):
    pts, feats = _auto_cloud()
    K, R2, t2 = _auto_scene()
    cloud = interop.pointclouds_from_arrays(pts, [5000, 5000], feats,
                                            device="cpu")
    auto = port.AlphaPointRender(K, (128, 128), radius=0.02, device="cpu")
    st = auto.prepare(cloud, R2, t2)
    img = auto.render(cloud, R2, t2)
    explicit = port.AlphaPointRender(
        K, (128, 128), radius=0.02, bin_size=st.bin_size,
        max_points_per_bin=st.max_points_per_bin,
        active_tiles=st.active_tiles, device="cpu").render(cloud, R2, t2)
    assert torch.equal(img, explicit)
    dense = port.AlphaPointRender(K, (128, 128), radius=0.02, bin_size=0,
                                  device="cpu").render(cloud, R2, t2)
    np.testing.assert_allclose(img.numpy(), dense.numpy(), rtol=0, atol=1e-5)
    # a small cloud stays dense
    small = interop.pointclouds_from_arrays(pts[:, :512], [512, 512],
                                            device="cpu")
    assert auto.resolved_settings(small, R2, t2).bin_size == 0


def test_auto_guard_warns_on_denser_cloud(fresh_cache):
    """Budgets are cached per shape: a denser cloud of the same shape later
    trips the default "warn" guard instead of dropping points silently."""
    pts, feats = _auto_cloud()
    K, R2, t2 = _auto_scene()
    r = port.AlphaPointRender(K, (128, 128), radius=0.02, device="cpu")
    r.prepare(interop.pointclouds_from_arrays(pts, [5000, 5000], feats,
                                              device="cpu"), R2, t2)
    crowded = np.random.RandomState(1).randn(2, 5000, 3).astype(
        np.float32) * 0.02
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        r.render(interop.pointclouds_from_arrays(crowded, [5000, 5000],
                                                 feats, device="cpu"), R2, t2)
    assert any("overflow" in str(w.message) for w in rec)


def test_auto_grow_only_grows(fresh_cache):
    """tests/test_auto_settings.py::test_points_auto_grow_merges_budgets."""
    from torch_renderer_tpu_torch.rasterize.autotune import (
        resolve_points_settings,
    )

    rng = np.random.RandomState(0)
    sparse = Pointclouds.from_padded(rng.randn(1, 4000, 3).astype(
        np.float32) * 0.8, device="cpu")
    dense = Pointclouds.from_padded(rng.randn(1, 4000, 3).astype(
        np.float32) * 0.05, device="cpu")
    cam = port.PerspectiveCamera.from_K(
        _auto_scene()[0], (128, 128), R=np.eye(3, dtype=np.float32)[None],
        t=np.array([[0, 0, 3.0]], np.float32), device="cpu")
    s = PointsRasterizationSettings(image_size=(128, 128), radius=0.02)
    r0 = resolve_points_settings(s, sparse, cam)
    assert resolve_points_settings(s, dense, cam) == r0      # cache hit
    r2 = resolve_points_settings(s, dense, cam, grow=True)
    assert r2.max_points_per_bin > r0.max_points_per_bin
    r3 = resolve_points_settings(s, sparse, cam, grow=True)
    assert r3.max_points_per_bin == r2.max_points_per_bin


def test_pallas_impl_on_auto_dense_warns(fresh_cache):
    pts, feats = _auto_cloud(N=512)
    K, R2, t2 = _auto_scene()
    cloud = interop.pointclouds_from_arrays(pts, [512, 512], feats,
                                            device="cpu")
    for kw, text in ((dict(), "DENSE"), (dict(bin_size=0),
                                         "DENSE point path")):
        r = port.AlphaPointRender(K, (128, 128), radius=0.02, impl="pallas",
                                  device="cpu", **kw)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            img = r.render(cloud, R2, t2)
        assert torch.isfinite(img).all()
        assert any(text in str(w.message) for w in rec)

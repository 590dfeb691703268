"""Port parity: the sphere-based Pulsar renderer of torch_renderer_tpu_torch
(PulsarRenderer) against the JAX package on the CPU, and the sphere model's
flows of tests/test_pulsar.py on the port.

The gradient scene is tests/test_torch_point_render.py's: B=2 clouds of 600
points from N(0, 0.4) with RGB features, 64x64, f = 0.8 * 64, t = (0, 0,
2.5), world radius 0.03, K=8, tile 16, 256 points per bin, 12 active tiles
(the sphere renderer's budget sized against its NDC selection radii, as the
point bench sizes it). Tolerance: the gradient of sum(render^2) with
respect to the points within 1e-4 of its largest (sums through gathers and
scatter-adds in another order). The JAX reference runs its rasterization
jitted and its compositor op by op: the sphere blend is ill-conditioned
where b^2 = |c|^2 - t_c^2 is small, and a jitted blend sums in another
order (see tests/test_torch_point_render.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_renderer_tpu as jtrt
import torch_renderer_tpu_torch as port
from torch_renderer_tpu.rasterize import points as jpoints
from torch_renderer_tpu.structures.pointclouds import Pointclouds as JClouds
from torch_renderer_tpu_torch import interop
from torch_renderer_tpu_torch.structures.pointclouds import Pointclouds

B, P, S = 2, 600, 64
F_PIX = 0.8 * S
K_MAT = np.array([[F_PIX, 0, S / 2], [0, F_PIX, S / 2], [0, 0, 1]],
                 np.float32)
R = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy()
T = np.tile(np.array([0.0, 0.0, 2.5], np.float32), (B, 1))
SPHERE = dict(radius=0.03, bin_size=16, max_points_per_bin=256,
              active_tiles=12)


def test_sphere_gradients_match_jax():
    rng = np.random.default_rng(5)
    pts = (rng.standard_normal((B, P, 3)) * 0.4).astype(np.float32)
    feats = rng.uniform(0, 1, (B, P, 3)).astype(np.float32)
    jraster = jax.jit(jpoints.rasterize_points, static_argnums=2)
    r = jtrt.PulsarRenderer(K_MAT, (S, S), **SPHERE)

    def loss(p):
        cloud = JClouds(points=p, num_points=jnp.full((B,), P, jnp.int32),
                        features=jnp.asarray(feats))
        return jnp.sum(r.render(cloud, jnp.asarray(R), jnp.asarray(T)) ** 2)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpoints, "rasterize_points",
                   lambda pcls, cam, st, radius=None, extra=None: jraster(
                       pcls, cam, st, radius, extra))
        want = np.asarray(jax.grad(loss)(jnp.asarray(pts)))

    x = torch.from_numpy(pts).requires_grad_(True)
    cloud = dataclasses.replace(interop.pointclouds_from_arrays(
        pts, [P] * B, feats, device="cpu"), points=x)
    img = port.PulsarRenderer(K_MAT, (S, S), device="cpu", **SPHERE).render(
        cloud, torch.from_numpy(R), torch.from_numpy(T))
    (g,) = torch.autograd.grad((img ** 2).sum(), x)
    assert np.isfinite(g.numpy()).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(g.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def _spheres(pts, feats):
    return Pointclouds.from_padded(np.asarray(pts, np.float32)[None],
                                   features=np.asarray(feats,
                                                       np.float32)[None],
                                   device="cpu")


EYE = np.eye(3, dtype=np.float32)[None]
ZERO = np.zeros((1, 3), np.float32)
K64 = np.array([[64.0, 0, 32], [0, 64.0, 32], [0, 0, 1]], np.float32)


def _sphere_renderer(**kw):
    return port.PulsarRenderer(K64, (64, 64), device="cpu", **kw)


def test_pulsar_sphere_flows():
    # one sphere: its colour at the centre, background outside
    out = _sphere_renderer(radius=0.5, gamma=1e-3).render(
        _spheres([[0.0, 0.0, 3.0]], [[1.0, 0.0, 0.0]]), EYE, ZERO)
    c = out[0, 32, 32]
    torch.testing.assert_close(c[:3], torch.tensor([1.0, 0.0, 0.0]),
                               atol=1e-3, rtol=0)
    assert float(c[3]) > 0.99 and float(out[0, 2, 2, 3]) < 1e-3
    # occlusion by intersection depth, not centre depth
    out = _sphere_renderer(radius=1.0, gamma=1e-3).render(
        _spheres([[0.0, 0.0, 3.0], [0.0, 0.0, 2.5]],
                 [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]), EYE, ZERO,
        radius=torch.tensor([[1.0, 0.05]]))
    c = out[0, 32, 32]
    assert float(c[0]) > 0.95 and float(c[1]) < 0.05
    # a transparent front sphere shows the one behind
    two = _spheres([[0.0, 0.0, 2.0], [0.0, 0.0, 3.0]],
                   [[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]])
    out = _sphere_renderer(radius=0.4, gamma=1e-3).render(
        two, EYE, ZERO, opacity=torch.tensor([[0.0, 1.0]]))
    assert float(out[0, 32, 32, 0]) > 0.9 and float(out[0, 32, 32, 1]) < 0.1
    # a large gamma blends both
    out = _sphere_renderer(radius=0.4, gamma=1.0).render(
        _spheres([[0.0, 0.0, 2.6], [0.0, 0.0, 3.0]],
                 [[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]]), EYE, ZERO)
    assert float(out[0, 32, 32, 0]) > 0.2 and float(out[0, 32, 32, 1]) > 0.2
    # background colour and alpha
    out = _sphere_renderer(radius=0.2, gamma=1e-3, background=0.5).render(
        _spheres([[0.0, 0.0, 2.0]], [[0.0, 0.0, 1.0]]), EYE, ZERO)
    torch.testing.assert_close(out[0, 1, 1, :3], torch.full((3,), 0.5),
                               atol=1e-4, rtol=0)
    assert float(out[0, 1, 1, 3]) < 1e-3


def test_pulsar_gradients_reach_positions_and_radii():
    pts = torch.tensor([[[0.1, -0.05, 2.5], [-0.2, 0.1, 3.0]]],
                       requires_grad=True)
    r_w = torch.tensor([[0.3, 0.4]], requires_grad=True)
    out = _sphere_renderer(gamma=1e-2).render(
        Pointclouds.from_padded(pts), EYE, ZERO, radius=r_w)
    for g in torch.autograd.grad(out[..., 3].sum(), (pts, r_w)):
        assert torch.isfinite(g).all() and float(g.abs().max()) > 0

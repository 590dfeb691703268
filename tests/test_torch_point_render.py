"""Port parity: the five point renderers and the compositors of
torch_renderer_tpu_torch against the JAX package on the CPU (the binned
renderers run the points_select kernel's plain version here).

The scene is tests/test_pulsar.py's binned one at a smaller image: B=2
clouds of 600 points drawn from N(0, 0.4) with uniform [0, 1) RGB features,
64x64, f = 0.8 * 64, R = I, t = (0, 0, 2.5), splat radius 0.03, K=8, tile
16; the sphere renderer with 12 active tiles. The compositor flows mirror
tests/test_points.py.

Tolerances: images within 1e-5 (float32 sums over K in another order);
gradients with respect to the points within 1e-4 of their largest (sums
through gathers and scatter-adds in another order).

The JAX reference runs its rasterization jitted (compiled once per
settings) and its compositors op by op, as an eager caller runs them: a
jitted compositor sums in another order, and the norm and sphere blends
are ill-conditioned where weights are small (the norm weight 1 - d^2/r^2
at a splat's rim; the sphere's b^2 = |c|^2 - t_c^2), so at this scene the
fully jitted JAX images differ from the op-by-op ones by up to 3e-5
(norm) and 6e-3 (sphere), while the jitted rasterization changes nothing.
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
from torch_renderer_tpu_torch.shading.compositing import (
    alpha_composite,
    norm_weighted_composite,
)
from torch_renderer_tpu_torch.structures.pointclouds import Pointclouds

B, P, S = 2, 600, 64
F_PIX = 0.8 * S
K_MAT = np.array([[F_PIX, 0, S / 2], [0, F_PIX, S / 2], [0, 0, 1]],
                 np.float32)
R = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy()
T = np.tile(np.array([0.0, 0.0, 2.5], np.float32), (B, 1))
BIN = dict(radius=0.03, bin_size=16, max_points_per_bin=256)
# name -> (renderer class, constructor kwargs, render kwargs)
CASES = {
    "alpha": ("AlphaPointRender", BIN, {}),
    "norm": ("NormPointRender", BIN, {}),
    "pulsar_splat": ("PulsarPointRender", BIN, {"radius": "per_point"}),
    "pulsar_sphere": ("PulsarRenderer", dict(BIN, active_tiles=12), {}),
    "depth": ("DepthPointRender", BIN, {}),
}
GRAD_CASES = ("alpha",)


def _arrays():
    rng = np.random.default_rng(5)
    pts = (rng.standard_normal((B, P, 3)) * 0.4).astype(np.float32)
    feats = rng.uniform(0, 1, (B, P, 3)).astype(np.float32)
    radii = rng.uniform(0.01, 0.05, (B, P)).astype(np.float32)
    return pts, feats, radii


def _render_kw(kw, radii, lib):
    return {k: lib.asarray(radii) if v == "per_point" else v
            for k, v in kw.items()}


def _port(name):
    cls, ctor, _ = CASES[name]
    return getattr(port, cls)(K_MAT, (S, S), device="cpu", **ctor)


def _port_cloud(pts, feats):
    return interop.pointclouds_from_arrays(pts, [P] * B, feats, device="cpu")


@pytest.fixture(scope="module")
def ref():
    """Every case's JAX image and the alpha gradient of sum(render^2) with
    respect to the points."""
    pts, feats, radii = _arrays()
    Rj, Tj = jnp.asarray(R), jnp.asarray(T)
    jraster = jax.jit(jpoints.rasterize_points, static_argnums=2)

    def cloud(p):
        return JClouds(points=p, num_points=jnp.full((B,), P, jnp.int32),
                       features=jnp.asarray(feats))

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpoints, "rasterize_points",
                   lambda pcls, cam, st, radius=None, extra=None: jraster(
                       pcls, cam, st, radius, extra))
        for name, (cls, ctor, rkw) in CASES.items():
            r = getattr(jtrt, cls)(K_MAT, (S, S), **ctor)
            kw = _render_kw(rkw, radii, jnp)

            def render(p, r=r, kw=kw):
                return r.render(cloud(p), Rj, Tj, **kw)

            out[name] = np.asarray(render(jnp.asarray(pts)))
            if name in GRAD_CASES:
                out[name, "grad"] = np.asarray(jax.grad(
                    lambda p, render=render: jnp.sum(render(p) ** 2))(
                        jnp.asarray(pts)))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_renderer_matches_jax(ref, name):
    pts, feats, radii = _arrays()
    kw = _render_kw(CASES[name][2], radii, torch)
    img = _port(name).render(_port_cloud(pts, feats), torch.from_numpy(R),
                             torch.from_numpy(T), **kw)
    want = ref[name]
    assert img.shape == want.shape
    np.testing.assert_allclose(img.numpy(), want, rtol=0, atol=1e-5)
    if img.ndim == 4:
        assert float(img[..., 3].max()) > 0.5


@pytest.mark.parametrize("name", GRAD_CASES)
def test_renderer_gradients_match_jax(ref, name):
    pts, feats, _ = _arrays()
    x = torch.from_numpy(pts).requires_grad_(True)
    cloud = dataclasses.replace(_port_cloud(pts, feats), points=x)
    img = _port(name).render(cloud, torch.from_numpy(R), torch.from_numpy(T))
    (g,) = torch.autograd.grad((img ** 2).sum(), x)
    want = ref[name, "grad"]
    assert np.isfinite(g.numpy()).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(g.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


# ---------------------------------------------------------------------------
# compositors and flows (tests/test_points.py)
# ---------------------------------------------------------------------------

EYE = np.eye(3, dtype=np.float32)[None]
ZERO = np.zeros((1, 3), np.float32)
K64 = np.array([[64.0, 0, 32], [0, 64.0, 32], [0, 0, 1]], np.float32)


def test_alpha_and_norm_composite():
    w = torch.tensor([1.0, 0.5]).reshape(1, 1, 1, 2)
    w2 = torch.tensor([0.5, 0.5]).reshape(1, 1, 1, 2)
    feats = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]).reshape(
        1, 1, 1, 2, 3)
    out = alpha_composite(w, feats)[0, 0, 0]
    torch.testing.assert_close(out, torch.tensor([1.0, 0.0, 0.0, 1.0]))
    out = norm_weighted_composite(w2, feats)[0, 0, 0]
    torch.testing.assert_close(out[:3], torch.tensor([0.5, 0.5, 0.0]))


def test_point_render_gradient_flows_and_depth():
    """A norm render's alpha has a finite, nonzero gradient to the
    positions; the depth render is the nearest splat's z, 0 elsewhere."""
    pts = torch.tensor([[[0.05, 0.0, 2.0], [-0.05, 0.02, 2.2]]],
                       requires_grad=True)
    out = port.NormPointRender(K64, (64, 64), radius=0.08,
                               device="cpu").render(
        Pointclouds.from_padded(pts), EYE, ZERO)
    (g,) = torch.autograd.grad(out[..., 3].sum(), pts)
    assert torch.isfinite(g).all() and float(g.abs().sum()) > 0
    depth = port.DepthPointRender(K64, (64, 64), radius=0.08,
                                  device="cpu").render(
        Pointclouds.from_padded(pts.detach()), EYE, ZERO)
    covered = depth > 0
    assert depth.shape == (1, 64, 64) and int(covered.sum()) > 20
    z = depth[covered].numpy()
    assert np.isin(z, np.float32([2.0, 2.2])).all()


def test_point_entry_points_without_card_raise(monkeypatch):
    """With no CUDA device and no device=, the point entry points raise and
    say how to ask for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((1, 4, 3), np.float32)
    for make in (
            lambda: port.AlphaPointRender(K64, (8, 8)),
            lambda: port.PulsarRenderer(K64, (8, 8)),
            lambda: Pointclouds.from_padded(pts),
            lambda: interop.pointclouds_from_arrays(pts, [4])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    # given tensors, they follow the tensors' device
    assert Pointclouds.from_padded(torch.zeros(1, 4, 3)).points.device.type \
        == "cpu"
    assert port.NormPointRender(torch.eye(3), (8, 8)).device.type == "cpu"

"""Port parity: blending, lights, Phong shading and MeshRenderer of
torch_renderer_tpu_torch against the JAX package on the CPU.

Inputs come from a numpy seed or the icosphere; lights and materials are
carried across through interop. The renderer scene is the pose app's at
64x64: icosphere(2) normalized to the unit sphere (320 faces, so auto
settings bin it), pinhole K at focal scale 0.9, look_at(2.7, 15, 40).
Tolerances: blending and lighting within 1e-5 (float32, same formulas);
rendered depth, silhouette and RGB within 1e-4; vertex and pose gradients
within 2e-3 of the largest gradient (sums in another order, and
selection-depth ties that may pick the other of two equal faces).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_renderer_tpu.cameras.look_at import look_at_view_transform
from torch_renderer_tpu.ops.icosphere import icosphere
from torch_renderer_tpu.opt.pose_fit import pose_params_to_Rt
from torch_renderer_tpu.rasterize.fragments import Fragments
from torch_renderer_tpu.renderer import MeshRenderer
from torch_renderer_tpu.shading import blending, phong
from torch_renderer_tpu.shading.lights import (
    DirectionalLights,
    Materials,
    PointLights,
)
from torch_renderer_tpu.structures.meshes import Meshes
from torch_renderer_tpu_torch import interop
from torch_renderer_tpu_torch import renderer as prenderer
from torch_renderer_tpu_torch.opt import pose_fit as ppose
from torch_renderer_tpu_torch.rasterize import fragments as pfragments
from torch_renderer_tpu_torch.shading import blending as pblending
from torch_renderer_tpu_torch.shading import lights as plights
from torch_renderer_tpu_torch.shading import phong as pphong

IMG = 64
BLUR = math.log(1.0 / 1e-4 - 1.0) * 1e-4
CONFIGS = {"fragments": dict(faces_per_pixel=4, blur_radius=BLUR),
           "k1": dict(faces_per_pixel=1, blur_radius=0.0)}


def _random_fragments(seed=0, B=2, H=6, W=7, K=3):
    rng = np.random.default_rng(seed)
    p2f = rng.integers(-1, 20, size=(B, H, W, K))
    zbuf = np.where(p2f >= 0, rng.uniform(1.0, 3.0, p2f.shape), -1.0)
    dists = np.where(p2f >= 0, rng.normal(0, 3e-4, p2f.shape), 1e10)
    bary = rng.dirichlet(np.ones(3), size=p2f.shape) * (p2f >= 0)[..., None]
    arrays = [a.astype(dt) for a, dt in ((p2f, np.int32), (zbuf, np.float32),
                                         (bary, np.float32),
                                         (dists, np.float32))]
    jf = Fragments(*(jnp.asarray(a) for a in arrays))
    pf = pfragments.Fragments(*(torch.from_numpy(a.astype(np.int64)
                                                 if a.dtype == np.int32
                                                 else a) for a in arrays))
    colors = rng.uniform(size=(B, H, W, K, 3)).astype(np.float32)
    return jf, pf, colors


def test_blending_matches_jax():
    jf, pf, colors = _random_fragments()
    bp = blending.BlendParams(sigma=1e-4, gamma=1e-4,
                              background_color=(0.1, 0.2, 0.3))
    pbp = pblending.BlendParams(**dataclasses.asdict(bp))
    np.testing.assert_allclose(
        pblending.sigmoid_alpha(pf, 1e-4).numpy(),
        np.asarray(blending.sigmoid_alpha(jf, 1e-4)), atol=1e-6)
    for kc in (3, 2):
        np.testing.assert_allclose(
            pblending.softmax_rgb_blend(torch.from_numpy(colors[..., :kc, :]),
                                        pf, pbp).numpy(),
            np.asarray(blending.softmax_rgb_blend(
                jnp.asarray(colors[..., :kc, :]), jf, bp)), atol=1e-5)
    np.testing.assert_allclose(
        pblending.hard_rgb_blend(torch.from_numpy(colors), pf, pbp).numpy(),
        np.asarray(blending.hard_rgb_blend(jnp.asarray(colors), jf, bp)),
        atol=1e-6)


def _carry_lights(lights):
    if isinstance(lights, PointLights):
        return interop.point_lights_from_arrays(
            *(np.asarray(getattr(lights, f.name))
              for f in dataclasses.fields(lights)))
    return plights.DirectionalLights(*(
        torch.from_numpy(np.array(getattr(lights, f.name)))
        for f in dataclasses.fields(lights)))


def _carry_materials(m):
    return interop.materials_from_arrays(
        *(np.asarray(getattr(m, f.name)) for f in dataclasses.fields(m)))


@pytest.mark.parametrize("lights", [
    PointLights.make(location=((1.0, 2.0, -3.0),)),
    DirectionalLights.make(direction=((0.3, -1.0, 0.5),)),
])
def test_phong_lighting_matches_jax(lights):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(2, 5, 4, 3)).astype(np.float32)
    nrm = rng.normal(size=(2, 5, 4, 3)).astype(np.float32)
    cam = rng.normal(size=(2, 3)).astype(np.float32) * 3
    mats = Materials.make(shininess=32.0, specular=((0.5, 0.6, 0.7),))
    j = phong.phong_lighting(jnp.asarray(pts), jnp.asarray(nrm),
                             jnp.asarray(cam), lights, mats)
    p = pphong.phong_lighting(torch.from_numpy(pts), torch.from_numpy(nrm),
                              torch.from_numpy(cam), _carry_lights(lights),
                              _carry_materials(mats))
    for a, b in zip(p, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def _scene():
    verts, faces = icosphere(2)
    jm, _, _ = Meshes.from_single(verts, faces).center_and_scale_to_unit_sphere()
    pm = interop.meshes_from_arrays(jm.verts, jm.faces, jm.num_verts,
                                    jm.num_faces)
    f = 0.9 * IMG
    K = np.array([[f, 0, IMG / 2], [0, f, IMG / 2], [0, 0, 1]], np.float32)
    R, t = look_at_view_transform(2.7, 15.0, 40.0)
    return jm, pm, K, np.asarray(R)[0], np.asarray(t)[0]


def _renderers(K, config, **jax_kw):
    lights = PointLights.make(location=((0.5, -1.0, -2.0),),
                              diffuse=((0.4, 0.3, 0.2),))
    mats = Materials.make(shininess=16.0)
    jr = MeshRenderer(K, (IMG, IMG), lights=lights, materials=mats,
                      **CONFIGS[config], **jax_kw)
    pr = prenderer.MeshRenderer(K, (IMG, IMG), lights=_carry_lights(lights),
                                materials=_carry_materials(mats),
                                **CONFIGS[config])
    return jr, pr


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_mesh_renderer_matches_jax(config):
    jm, pm, K, R, t = _scene()
    jr, pr = _renderers(K, config)
    jo = jr.render(jm, R, t, with_silhouette=True, with_rgb=True)
    po = pr.render(pm, R, t, with_silhouette=True, with_rgb=True)
    assert pr.resolved_settings(pm, R, t).bin_size == 16
    assert po.rgb.shape == (1, IMG, IMG, 3)
    assert float(po.depth.max()) > 1.0 and float(po.silhouette.max()) > 0.9
    for name in ("depth", "zbuf", "silhouette", "rgb"):
        np.testing.assert_allclose(getattr(po, name).numpy(),
                                   np.asarray(getattr(jo, name)), atol=1e-4,
                                   err_msg=name)


def test_render_gradients_match_jax():
    """Vertex and pose gradients of a depth + silhouette + RGB loss through
    the fragments configuration.

    The JAX side renders dense (bin_size=0), the port binned. At this pose
    the JAX package's own binned XLA path gives a silhouette vertex
    gradient up to 2.4% of the largest away from its dense path, with no
    budget overflow; the dense path is the reference. Pixels where the two
    packages break a selection-depth tie differently (equal zbuf, another
    face in a slot) get zero weight: in the blur band one pixel's sigmoid
    gradient at sigma=1e-4 can move a vertex gradient by a few percent."""
    jm, pm, K, R, t = _scene()
    jr, pr = _renderers(K, "fragments", bin_size=0)
    rng = np.random.default_rng(2)
    w = rng.uniform(size=(3, 1, IMG, IMG)).astype(np.float32)
    params = {"t": t[None] + np.float32([0.02, -0.01, 0.03]),
              "quat": ppose.pose_params_from_Rt(R, t)["quat"].numpy()}

    Rj, tj = pose_params_to_Rt({k: jnp.asarray(v) for k, v in params.items()})
    jf = jr.render(jm, Rj, tj).fragments
    Rp, tp = ppose.pose_params_to_Rt({k: torch.from_numpy(v)
                                      for k, v in params.items()})
    pf = pr.render(pm, Rp, tp).fragments
    flip = (pf.pix_to_face.numpy() != np.asarray(jf.pix_to_face))
    # the dense reference evaluates edge functions by an einsum, which
    # rounds differently from the binned per-channel form: a few more ties
    assert flip.any(-1).mean() < 2e-3
    np.testing.assert_allclose(pf.zbuf.numpy()[flip],
                               np.asarray(jf.zbuf)[flip], atol=1e-5)
    w = w * ~flip.any(-1)

    def jloss(v, prm):
        Rj, tj = pose_params_to_Rt(prm)
        o = jr.render(Meshes(v, jm.faces, jm.num_verts, jm.num_faces), Rj,
                      tj, with_silhouette=True, with_rgb=True)
        return (jnp.mean(o.depth * w[0]) + jnp.mean(o.silhouette * w[1])
                + jnp.mean(o.rgb.sum(-1) * w[2]))

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jm.verts, {k: jnp.asarray(v) for k, v in params.items()})

    v = pm.verts.clone().requires_grad_(True)
    prm = {k: torch.from_numpy(np.array(a)).requires_grad_(True)
           for k, a in params.items()}
    Rp, tp = ppose.pose_params_to_Rt(prm)
    o = pr.render(dataclasses.replace(pm, verts=v), Rp, tp,
                  with_silhouette=True, with_rgb=True)
    wt = torch.from_numpy(w)
    (o.depth * wt[0]).mean().add((o.silhouette * wt[1]).mean()).add(
        (o.rgb.sum(-1) * wt[2]).mean()).backward()
    pairs = [(v.grad, jg[0])] + [(prm[k].grad, jg[1][k]) for k in ("t",
                                                                  "quat")]
    for got, want in pairs:
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=2e-3 * np.abs(want).max())

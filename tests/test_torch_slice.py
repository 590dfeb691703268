"""The soft-silhouette slice end to end: the bench's chained render + grad
step through the port against the same step written with the JAX package,
on the CPU at a small size; plus the port's import boundary and the
occupancy split it does not carry.

The step is bench.py's: v <- v - 1e-6 * d sum(alpha) / dv, with the budgets
sized once by suggest_soft_config(layout="packed"). Tolerance: each step's
gradient and the final vertices within 5e-3 of their max magnitude.
"""

import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_renderer_tpu_torch as port
from torch_renderer_tpu.cameras.perspective import PerspectiveCamera
from torch_renderer_tpu.ops.icosphere import icosphere
from torch_renderer_tpu.rasterize.geometry import setup_face_planes
from torch_renderer_tpu.rasterize.pallas_soft import (
    soft_silhouette_pallas_fd,
    suggest_soft_config,
)
from torch_renderer_tpu.structures.meshes import Meshes

REPO = pathlib.Path(__file__).resolve().parents[1]
IMG = 32
B = 2
SIGMA = 1e-4
STEPS = 3


def _scene():
    verts, faces = icosphere(1)
    f = 0.8 * IMG
    K = np.array([[f, 0, IMG / 2], [0, f, IMG / 2], [0, 0, 1]], np.float32)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3))
    t = np.array([[0.0, 0.0, 3.0], [0.15, -0.1, 2.6]], np.float32)
    return verts, faces, K, R, t


def _jax_steps():
    verts, faces, K, R, t = _scene()
    meshes = Meshes.from_single(verts, faces).extend(B)
    cam = PerspectiveCamera.from_K(K, (IMG, IMG), R=R, t=t)
    cfg = suggest_soft_config(setup_face_planes(meshes, cam), (IMG, IMG),
                              sigma=SIGMA, layout="packed")

    def loss_fn(v):
        fp = setup_face_planes(meshes.update_padded(v), cam)
        return jnp.sum(soft_silhouette_pallas_fd(
            fp, (IMG, IMG), sigma=SIGMA, **cfg.kwargs()))

    grad_fn = jax.jit(jax.grad(loss_fn))
    v, grads = meshes.verts, []
    for _ in range(STEPS):
        g = grad_fn(v)
        grads.append(np.asarray(g))
        v = v - 1e-6 * g
    return cfg, grads, np.asarray(v)


def _port_steps():
    verts, faces, K, R, t = _scene()
    meshes = port.Meshes.from_single(verts, faces, device="cpu").extend(B)
    cam = port.PerspectiveCamera.from_K(K, (IMG, IMG), R=R, t=t,
                                        device="cpu")
    cfg = port.suggest_soft_config(port.setup_face_planes(meshes, cam),
                                   (IMG, IMG), sigma=SIGMA, layout="packed")
    v, grads = meshes.verts, []
    for _ in range(STEPS):
        v = v.detach().requires_grad_(True)
        fp = port.setup_face_planes(meshes.update_padded(v), cam)
        alpha = port.soft_silhouette_fd(fp, (IMG, IMG), sigma=SIGMA,
                                        **cfg.kwargs())
        alpha.sum().backward()
        grads.append(v.grad.numpy().copy())
        v = v.detach() - 1e-6 * v.grad
    return cfg, grads, v.numpy()


def test_bench_steps_match_jax():
    jcfg, jgrads, jv = _jax_steps()
    pcfg, pgrads, pv = _port_steps()
    assert pcfg.kwargs() == jcfg.kwargs()
    assert pcfg.layout == "packed"
    assert np.abs(pgrads[0]).sum() > 0
    for step, (pg, jg) in enumerate(zip(pgrads, jgrads)):
        assert np.isfinite(pg).all()
        np.testing.assert_allclose(pg, jg, atol=5e-3 * np.abs(jg).max(),
                                   err_msg=f"step {step}")
    np.testing.assert_allclose(pv, jv, atol=5e-3 * np.abs(jv).max())


def test_import_pulls_in_no_jax():
    """The package and every module in it import without JAX."""
    code = ("import importlib, pkgutil, sys, torch_renderer_tpu_torch as p\n"
            "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
            "'torch_renderer_tpu_torch.')]\n"
            "assert len(mods) > 30, mods\n"
            "new = {'structures.textures', 'structures.pointclouds', "
            "'ops.cuda_texsample', 'ops.mesh_losses', 'ops.sample_points', "
            "'ops.knn_chamfer', 'opt.deform_color', 'opt.deform', "
            "'io.obj', 'apps._common', 'apps.joint_shape_texture', "
            "'apps.deform_from_pcd', '_device', 'rasterize.points', "
            "'rasterize.cuda_points', 'shading.compositing'}\n"
            "assert {'torch_renderer_tpu_torch.' + m for m in new} <= "
            "set(mods), sorted(mods)\n"
            "for m in mods: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'torch_renderer_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_sources_do_not_import_jax():
    banned = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|torch_renderer_tpu)\b"
                        r"(?!_)", re.M)
    sources = list((REPO / "torch_renderer_tpu_torch").rglob("*.py"))
    assert len(sources) > 30
    for path in sources:
        assert not banned.search(path.read_text()), path


@pytest.mark.parametrize("kwargs,match", [
    pytest.param(dict(layout="packed", active_tiles=4, hi_tiles=8),
                 "hi_tiles", id="kwargs1-hi_tiles"),
    pytest.param(dict(layout="lane", hi_tiles=8), None,
                 id="kwargs2-hi_tiles"),
])
def test_unported_layouts_raise(kwargs, match):
    """The occupancy split: the packed layout rejects hi_tiles that are not
    below the active tiles (ValueError, as in the JAX package); the lane
    layout ignores hi_tiles."""
    verts, faces, K, R, t = _scene()
    meshes = port.Meshes.from_single(verts, faces, device="cpu").extend(B)
    cam = port.PerspectiveCamera.from_K(K, (IMG, IMG), R=R, t=t,
                                        device="cpu")
    if match is not None:
        with pytest.raises(ValueError, match=match):
            port.soft_silhouette_cuda(meshes, cam, **kwargs)
        return
    plain = {k: v for k, v in kwargs.items() if k != "hi_tiles"}
    assert torch.equal(port.soft_silhouette_cuda(meshes, cam, **kwargs),
                       port.soft_silhouette_cuda(meshes, cam, **plain))


def test_packed_requires_active_tiles():
    verts, faces, K, R, t = _scene()
    meshes = port.Meshes.from_single(verts, faces, device="cpu").extend(B)
    cam = port.PerspectiveCamera.from_K(K, (IMG, IMG), R=R, t=t,
                                        device="cpu")
    with pytest.raises(ValueError, match="active_tiles"):
        port.soft_silhouette_cuda(meshes, cam, layout="packed")

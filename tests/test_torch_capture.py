"""The loops' captured form (utils/graph.py) on the CPU, where nothing is
captured: the bench step's static buffer, the fits' device step counter,
their history buffer, the joint fit's learning rates computed from that
counter, and the deferred "warn" budget checks, run eagerly and held
against the eager loops they replace (copied here as they were: a new v
each bench step, metrics stacked a step at a time, the joint fit's view
row and learning rate picked by the host's loop index). The CPU runs the
same operations in the same order, so each must equal its old loop bit
for bit. No JAX here.

The card's cases (captured against eager) are in
tests/test_torch_cuda_kernels.py.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from torch_renderer_tpu_torch import bench
from torch_renderer_tpu_torch.apps._common import pinhole_K
from torch_renderer_tpu_torch.cameras.look_at import look_at_view_transform
from torch_renderer_tpu_torch.opt import deform_color as dc
from torch_renderer_tpu_torch.opt import pose_fit as pf
from torch_renderer_tpu_torch.ops.icosphere import icosphere
from torch_renderer_tpu_torch.rasterize.binning import (
    check_budget,
    deferred_budget_checks,
)
from torch_renderer_tpu_torch.structures.meshes import Meshes
from torch_renderer_tpu_torch.structures.textures import sphere_uv_mapping
from torch_renderer_tpu_torch.utils.graph import StepGraph, resolve_capture

IMG = 32
ITERS = 6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module: the suite runs several workers
    on one machine, where torch's default of one thread per core
    oversubscribes it and the fits slow down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _assert_dicts_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_bench_step_static_buffer_equals_eager_step():
    p = bench.QUICK
    meshes, cam = bench.scene(p["batch"], p["image"], p["level"], "cpu")
    static, cfg = bench.make_step(meshes, cam)
    eager, _ = bench.make_step(meshes, cam, cfg=cfg, capture=False)
    v_s = v_e = meshes.verts
    for _ in range(3):
        v_s, g_s = static(v_s)
        v_e, g_e = eager(v_e)
        assert torch.equal(g_s, g_e) and torch.equal(v_s, v_e)
    assert not torch.equal(v_s, meshes.verts)


def _pose_scene():
    verts, faces = icosphere(2)       # 320 faces: binned at 32^2
    meshes = Meshes.from_single(verts, faces, device="cpu")
    meshes, _, _ = meshes.center_and_scale_to_unit_sphere()
    R, t = look_at_view_transform(2.7, 15.0, 40.0)
    R, t = R[0].numpy(), t[0].numpy()
    t0 = t + np.float32([0.06, -0.04, 0.05])
    return meshes, pinhole_K((IMG, IMG)), R, t, t0


def _old_pose_loop(fitter, meshes, refs, params0, n):
    """CameraPoseFitter.fit before the captured route."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params0.items()}
    fitter.prepare(meshes, params)
    opt = torch.optim.Adam(list(params.values()), lr=fitter.config.lr)
    rows = []
    for _ in range(n):
        opt.zero_grad(set_to_none=True)
        total, metrics = fitter.loss(params, meshes, refs)
        total.backward()
        opt.step()
        rows.append({k: v.detach() for k, v in metrics.items()})
    return ({k: v.detach() for k, v in params.items()},
            {k: torch.stack([r[k] for r in rows]) for k in rows[0]})


@pytest.mark.parametrize("route", ["fragments", "pallas"])
def test_pose_fit_equals_old_loop(route):
    meshes, K, R, t, t0 = _pose_scene()
    fitter = pf.CameraPoseFitter(K, (IMG, IMG), pf.PoseFitConfig(lr=5e-3),
                                 silhouette_impl=route, device="cpu")
    refs = fitter.make_references(meshes, R, t)
    params0 = pf.pose_params_from_Rt(R, t0, "cpu")
    assert fitter.renderer.resolved_settings(meshes, R, t0).bin_size
    params, hist = fitter.fit(meshes, refs, params0, n_steps=ITERS)
    want_p, want_h = _old_pose_loop(fitter, meshes, refs, params0, ITERS)
    _assert_dicts_equal(params, want_p)
    _assert_dicts_equal(hist, want_h)
    assert hist["loss"].shape == (ITERS,)
    assert hist["loss"][-1] < hist["loss"][0]


def _joint_setup():
    verts, faces = icosphere(2)
    src = Meshes.from_single(verts, faces, device="cpu")
    uvs = torch.as_tensor(sphere_uv_mapping(verts))
    tgt = src.offset_verts(src.verts[0] * torch.tensor([0.0, -0.3, -0.1]))
    cfg = dc.JointFitConfig(n_views=4, views_per_step=2, texture_size=32,
                            lr_decay_steps=2, n_steps=ITERS)
    fitter = dc.JointShapeTextureFitter(pinhole_K((IMG, IMG)), (IMG, IMG),
                                        cfg, device="cpu")
    return fitter, src, uvs, fitter.make_dataset(tgt)


def _old_joint_loop(fitter, src, uvs, ds, generator, n):
    """JointShapeTextureFitter.fit before the captured route."""
    from torch_renderer_tpu_torch.ops.mesh_losses import build_topology

    cfg = fitter.config
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in fitter.init_params(src).items()}
    opt = torch.optim.Adam([
        {"params": [params["deform"]], "lr": cfg.lr_verts},
        {"params": [params["texture_map"]], "lr": cfg.lr_texture}])
    base = (cfg.lr_verts, cfg.lr_texture)
    views = fitter.view_schedule(generator, n)
    topo = build_topology(src)
    rows, lrs = [], []
    for i in range(n):
        scale = cfg.lr_decay_rate ** (i // cfg.lr_decay_steps)
        for group, lr in zip(opt.param_groups, base):
            group["lr"] = lr * scale
        lrs.append(lr * scale)
        opt.zero_grad(set_to_none=True)
        total, metrics = fitter.loss(params, src, topo, uvs, ds, views[i])
        total.backward()
        opt.step()
        rows.append({k: v.detach() for k, v in metrics.items()})
    return ({k: v.detach() for k, v in params.items()},
            {k: torch.stack([r[k] for r in rows]) for k in rows[0]}, lrs)


def test_joint_fit_equals_old_loop():
    """lr_decay_steps=2: the staircase halves the rates after steps 2 and
    4, computed from the device counter in the step."""
    fitter, src, uvs, ds = _joint_setup()
    params, hist = fitter.fit(src, uvs, ds, torch.Generator().manual_seed(3))
    want_p, want_h, lrs = _old_joint_loop(
        fitter, src, uvs, ds, torch.Generator().manual_seed(3), ITERS)
    assert lrs[-1] == 0.25 * fitter.config.lr_texture
    _assert_dicts_equal(params, want_p)
    _assert_dicts_equal(hist, want_h)
    assert float(params["deform"].abs().max()) > 0


def _overflow_fitter(lr):
    meshes, K, R, t, t0 = _pose_scene()
    fitter = pf.DepthPoseFitter(
        K, (IMG, IMG), pf.PoseFitConfig(lr=lr, use_rgb=False), device="cpu",
        bin_size=16, max_faces_per_bin=8, check_budgets="warn")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        refs = fitter.make_references(meshes, R, t)
    return fitter, meshes, refs, pf.pose_params_from_Rt(R, t0, "cpu")


def test_deferred_warn_warns_once_with_eager_message():
    """An undersized max_faces_per_bin under "warn": the fit's steps
    record the count on the device and the loop warns once, after its last
    step, with the message one eager render gives (lr 0 keeps the pose, so
    every step sees the count of that render)."""
    fitter, meshes, refs, params0 = _overflow_fitter(0.0)
    with warnings.catch_warnings(record=True) as eager:
        warnings.simplefilter("always")
        fitter.render(meshes, params0)
    with warnings.catch_warnings(record=True) as fit:
        warnings.simplefilter("always")
        fitter.fit(meshes, refs, params0, n_steps=4)
    want = [str(w.message) for w in eager]
    got = [str(w.message) for w in fit]
    assert len(want) == 1 and "max_faces_per_bin overflow" in want[0]
    assert got == want


def test_deferred_warn_keeps_the_largest_count():
    with warnings.catch_warnings(record=True) as caught, \
            deferred_budget_checks() as rec:
        warnings.simplefilter("always")
        for n in (3, 9, 5):
            check_budget("faces", torch.tensor(n), 4, "warn", hint="h")
        assert not caught           # nothing read back inside the block
        assert int(rec.max[("faces", 4, "h")]) == 9
    msgs = [str(w.message) for w in caught]
    assert msgs == ["faces overflow: max count 9 > budget 4 — overflowing "
                    "work is silently dropped. h"]


def test_deferred_off_records_nothing():
    with warnings.catch_warnings(record=True) as caught, \
            deferred_budget_checks() as rec:
        warnings.simplefilter("always")
        check_budget("faces", torch.tensor(9), 4, "off")
    assert rec.max == {} and not caught
    fitter, meshes, refs, params0 = _overflow_fitter(1e-3)
    fitter.renderer.settings = dataclasses.replace(
        fitter.renderer.settings, check_budgets="off")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fitter.fit(meshes, refs, params0, n_steps=2)
    assert not [w for w in caught if "overflow" in str(w.message)]


def test_capture_on_cpu_raises():
    assert resolve_capture(None, "cpu") is False
    assert resolve_capture(False, "cpu") is False
    with pytest.raises(ValueError, match="CUDA"):
        StepGraph(lambda: None, "cpu", capture=True)
    meshes, K, R, t, t0 = _pose_scene()
    fitter = pf.CameraPoseFitter(K, (IMG, IMG), device="cpu")
    refs = fitter.make_references(meshes, R, t)
    with pytest.raises(ValueError, match="CUDA"):
        fitter.fit(meshes, refs, pf.pose_params_from_Rt(R, t0, "cpu"),
                   n_steps=1, capture=True)
    p = bench.QUICK
    m, cam = bench.scene(p["batch"], p["image"], p["level"], "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        bench.make_step(m, cam, capture=True)

"""The loops' captured form (utils/graph.py) on the CPU, where nothing is
captured: the bench step's static buffer, the fits' device step counter,
their history buffer, the joint fit's learning rates computed from that
counter, and the deferred "warn" budget checks, run eagerly and held
against the eager loops they replace (copied here as they were: a new v
each bench step, metrics stacked a step at a time, the joint fit's view
row and learning rate picked by the host's loop index; the deform and
vertex-colour fits' Python loops). The CPU runs the same operations in
the same order, so each must equal its old loop bit for bit. The jitted
calls' static inputs (CapturedCall: the depth app's chunk, the COCO
chunk and visibility count) run eagerly over their static copies
(StaticCopies below) and must equal fresh calls: scenes of different content
through one set of copies, so an input not copied in would show. No JAX
here.

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
from torch_renderer_tpu_torch.opt import deform as df
from torch_renderer_tpu_torch.opt import deform_color as dc
from torch_renderer_tpu_torch.opt import pose_fit as pf
from torch_renderer_tpu_torch.ops.icosphere import icosphere
from torch_renderer_tpu_torch.rasterize.binning import (
    check_budget,
    deferred_budget_checks,
)
from torch_renderer_tpu_torch.structures.meshes import Meshes
from torch_renderer_tpu_torch.structures.textures import (
    TexturesVertex,
    sphere_uv_mapping,
)
from torch_renderer_tpu_torch.utils import timing
from torch_renderer_tpu_torch.utils.graph import (
    CapturedCall,
    StepGraph,
    resolve_capture,
)

IMG = 32
ITERS = 6


class StaticCopies(CapturedCall):
    """A CapturedCall whose every call runs fn eagerly over the static
    copies of its inputs: what a replay reads, checked on the CPU."""

    def __call__(self, *args):
        from torch_renderer_tpu_torch.rasterize.binning import (
            recording_budgets,
        )

        with recording_budgets(self.budgets):
            return self._through_static(*args)


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


def _deform_setup():
    verts, faces = icosphere(2)
    src = Meshes.from_single(verts, faces, device="cpu")
    tgt = Meshes.from_single(verts * np.float32([1.0, 0.6, 0.4]), faces,
                             device="cpu")
    return df.MeshDeformer(src, target_meshes=tgt,
                           config=df.DeformConfig(n_samples=200))


def _old_deform_loop(deformer, generator, n, snapshot_every):
    """MeshDeformer.fit before the captured route."""
    cfg = deformer.config
    deform = deformer.init_params().requires_grad_(True)
    opt = torch.optim.SGD([deform], lr=cfg.lr, momentum=cfg.momentum)
    snapshots, rows = [], []
    for i in range(n):
        opt.zero_grad(set_to_none=True)
        total, metrics = deformer.loss(deform, generator)
        total.backward()
        opt.step()
        rows.append({k: v.detach() for k, v in metrics.items()})
        if snapshot_every > 0 and (i + 1) % snapshot_every == 0 \
                and i + 1 < n:
            snapshots.append(deformer.src.offset_verts(deform.detach()))
    deform = deform.detach()
    return (deformer.src.offset_verts(deform), deform,
            {k: torch.stack([r[k] for r in rows]) for k in rows[0]},
            snapshots)


def test_deform_fit_equals_old_loop():
    """The same generator seed: the same samples each step, so the same
    fit, snapshots (taken between steps) included."""
    deformer = _deform_setup()
    mesh, deform, hist, snaps = deformer.fit(
        torch.Generator().manual_seed(4), n_steps=ITERS, snapshot_every=2)
    w_mesh, w_deform, w_hist, w_snaps = _old_deform_loop(
        deformer, torch.Generator().manual_seed(4), ITERS, 2)
    assert torch.equal(deform, w_deform)
    assert torch.equal(mesh.verts, w_mesh.verts)
    _assert_dicts_equal(hist, w_hist)
    assert len(snaps) == len(w_snaps) == 2
    for a, b in zip(snaps, w_snaps):
        assert torch.equal(a.verts, b.verts)
    assert not torch.equal(snaps[0].verts, snaps[1].verts)
    assert hist["chamfer"][-1] < hist["chamfer"][0]


def _color_setup():
    verts, faces = icosphere(2)
    meshes = Meshes.from_single(verts, faces, device="cpu")
    gt = dataclasses.replace(meshes, textures=TexturesVertex(
        torch.as_tensor(np.clip(0.5 + 0.5 * verts, 0, 1))[None]))
    Rs, ts = look_at_view_transform(2.7, 15.0, torch.tensor([0.0, 120.0,
                                                             240.0]))
    fitter = df.VertexColorFitter(pinhole_K((IMG, IMG)), (IMG, IMG),
                                  df.ColorFitConfig(lr=5.0), device="cpu")
    refs = fitter.make_reference_views(gt, Rs, ts)
    return fitter, meshes, Rs.numpy(), ts.numpy(), refs


def _old_color_loop(fitter, meshes, Rs, ts, refs, n):
    """VertexColorFitter.fit before the captured route (poses passed to
    the renderer as given, every step)."""
    cfg = fitter.config
    rgb = torch.full(meshes.verts.shape[-2:], 0.5).requires_grad_(True)
    if fitter.renderer.settings.bin_size is None:
        fitter.renderer.prepare(fitter._views_batch(meshes, refs.shape[0]),
                                Rs, ts)
    opt = torch.optim.SGD([rgb], lr=cfg.lr, momentum=cfg.momentum)
    rows = []
    for _ in range(n):
        opt.zero_grad(set_to_none=True)
        total, metrics = fitter.loss(rgb, meshes, Rs, ts, refs)
        total.backward()
        opt.step()
        rows.append({k: v.detach() for k, v in metrics.items()})
    return rgb.detach(), {k: torch.stack([r[k] for r in rows])
                          for k in rows[0]}


def test_vertex_color_fit_equals_old_loop():
    """Poses as numpy arrays: the fit moves them to the device once; the
    old loop converted them in every render."""
    fitter, meshes, Rs, ts, refs = _color_setup()
    rgb, hist = fitter.fit(meshes, Rs, ts, refs, n_steps=ITERS)
    w_rgb, w_hist = _old_color_loop(fitter, meshes, Rs, ts, refs, ITERS)
    assert torch.equal(rgb, w_rgb)
    _assert_dicts_equal(hist, w_hist)
    assert hist["rgb_mse"][-1] < hist["rgb_mse"][0]


def test_creator_phases_equal_their_fits():
    """TwoPhaseCreator passes capture through: its phases equal the fits
    run directly (eager on the CPU)."""
    from torch_renderer_tpu_torch.opt.creator import (
        CreatorConfig,
        TwoPhaseCreator,
    )

    deformer = _deform_setup()
    verts = deformer.target_meshes.verts[0].numpy()
    target = dataclasses.replace(deformer.target_meshes, textures=(
        TexturesVertex(torch.as_tensor(np.clip(0.5 + 0.5 * verts, 0, 1))
                       [None])))
    cfg = CreatorConfig(geometry=deformer.config, n_color_views=3,
                        image_size=(IMG, IMG))
    creator = TwoPhaseCreator(deformer.src, target, cfg)
    g = creator.geometry_train(torch.Generator().manual_seed(2),
                               n_steps=ITERS, capture=None)
    _, deform, hist, _ = deformer.fit(torch.Generator().manual_seed(2),
                                      n_steps=ITERS, capture=False)
    assert torch.equal(g["deform"], deform)
    _assert_dicts_equal(g["history"], hist)
    c = creator.color_train(n_steps=3, capture=None)
    assert c["history"]["rgb_mse"].shape == (3,)
    assert bool(torch.isfinite(c["verts_rgb"]).all())


def _depth_chunks():
    """The depth app's renderer and inputs at a small size: two chunks of
    3 views of different azimuths, and one view."""
    from torch_renderer_tpu_torch.renderer import DepthRender

    meshes = Meshes.from_single(*icosphere(2), device="cpu")
    meshes, _, _ = meshes.center_and_scale_to_unit_sphere()
    azims = torch.linspace(0.0, 300.0, 6)
    Rs, ts = look_at_view_transform(2.7, 15.0, azims)
    renderer = DepthRender(pinhole_K((IMG, IMG)), (IMG, IMG), bin_size=16,
                           max_faces_per_bin=160, device="cpu")
    return renderer, meshes, Rs, ts


def test_depth_app_static_chunks_equal_fresh_renders():
    """The app's chunk loop (batch_render_bench: a CapturedCall per chunk
    shape, R and t copied into its static inputs, each chunk's depth
    copied into one preallocated result) against a fresh render of each
    chunk; the single view likewise."""
    renderer, meshes, Rs, ts = _depth_chunks()
    batched = meshes.extend(3)
    assert _expanded_dims(batched.verts) == (0,)

    @torch.no_grad()
    def render(R, t):
        return renderer.render(batched, R, t)

    call = StaticCopies(render, "cpu")
    single = StaticCopies(lambda R, t: renderer.render(meshes, R, t), "cpu")
    counted = timing.counters()["call_bodies"]
    views = torch.empty((6, IMG, IMG))
    for rep in range(2):
        for i in range(2):
            views[3 * i:3 * i + 3].copy_(call(Rs[3 * i:3 * i + 3],
                                              ts[3 * i:3 * i + 3]))
    counted = timing.counters()["call_bodies"] - counted
    with torch.no_grad():
        want = torch.cat([renderer.render(batched, Rs[:3], ts[:3]),
                          renderer.render(batched, Rs[3:], ts[3:])])
        one = renderer.render(meshes, Rs[4:5], ts[4:5])
    assert torch.equal(views, want)
    assert not torch.equal(views[:3], views[3:])
    assert torch.equal(single(Rs[4:5], ts[4:5]), one)
    assert call.bodies == 4 and len(call._graphs) == 1
    # each body is counted on the call and on the shared counter
    assert counted == call.bodies


def _expanded_dims(x):
    return tuple(d for d in range(x.ndim) if x.stride(d) == 0)


def _coco_scenes():
    """A generator (textured room, edges, the visibility check, 48x64, on
    the CPU) and two scenes of different content with their first chunk's
    inputs; both scenes' bins sized first, so one renderer build serves
    both."""
    from torch_renderer_tpu_torch.datagen import coco
    from torch_renderer_tpu_torch.shading.lights import PointLights

    cfg = coco.DataGenConfig(image_size=(48, 64), views_per_scene=4,
                             view_chunk=2, material_mode="texture",
                             room=True, edge_maps=True, min_visible_px=20,
                             texture_size=16)
    gen = coco.COCODataGenerator(coco.ObjectLibrary.primitives(level=1),
                                 cfg, device="cpu")
    rng = np.random.default_rng(5)
    scenes = []
    for k in range(2):
        scene, _ = gen.sample_scene(rng)
        Rs, ts = gen._sample_view_poses(rng, 4, gen._object_centers(scene))
        gen._ensure_bin_capacity(scene.meshes.extend(4), Rs, ts)
        lights = PointLights.make(location=((0.5, -0.4, 1.8 + k),),
                                  ambient=((0.3 + 0.2 * k,) * 3,),
                                  device="cpu")
        scenes.append((scene, Rs, ts, lights))
    return gen, scenes


def test_coco_static_calls_equal_fresh_calls():
    """Two scenes of different content (meshes, atlas, lights, face
    table, poses) through one set of static copies of the chunk render
    and of the visibility count, against fresh calls of their bodies."""
    gen, scenes = _coco_scenes()
    chunk = StaticCopies(gen._render_chunk, "cpu")
    vis = StaticCopies(gen._vis_chunk, "cpu")
    got, want = [], []
    for scene, Rs, ts, lights in scenes:
        batched = scene.meshes.extend(2)
        R, t = torch.as_tensor(Rs[:2]), torch.as_tensor(ts[:2])
        f2o = scene.face_to_object
        got.append([x.clone() for x in chunk(batched, R, t, lights, f2o)])
        want.append(gen._render_chunk(batched, R, t, lights, f2o))
        vb = dataclasses.replace(scene.meshes.extend(4), textures=None)
        Rv, tv = torch.as_tensor(Rs), torch.as_tensor(ts)
        got.append([vis(vb, Rv, tv, f2o).clone()])
        want.append([gen._vis_chunk(vb, Rv, tv, f2o)])
    assert len(chunk._graphs) == len(vis._graphs) == 1
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert torch.equal(a, b)
    # the scenes differ in every output: a stale input would repeat one
    for a, b in zip(got[0], got[2]):
        assert not torch.equal(a, b)
    assert not torch.equal(got[1][0], got[3][0])


def test_coco_render_scene_through_static_calls():
    """render_scene with the generator's calls static (what a replay
    reads): its outputs equal the eager generator's on the same scene."""
    gen, scenes = _coco_scenes()
    scene = scenes[1][0]
    want = gen.render_scene(scene, np.random.default_rng(3))
    gen._chunk_call = StaticCopies(gen._render_chunk, "cpu")
    gen._vis_call = StaticCopies(gen._vis_chunk, "cpu")
    gen._calls = [gen._chunk_call, gen._vis_call]
    before = gen.renders_traced
    got = gen.render_scene(scene, np.random.default_rng(3))
    for k in ("rgb", "depth", "normals", "segmentation", "edges", "R", "t"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert gen._chunk_call.bodies == 2 and gen._vis_call.bodies >= 1
    assert gen.renders_traced - before == \
        gen._chunk_call.bodies + gen._vis_call.bodies


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


def test_new_loops_capture_on_cpu_raises():
    """capture=True on the CPU raises for the deform and vertex-colour
    fits, the creator's phases, the jitted calls (CapturedCall) and the
    COCO generator."""
    from torch_renderer_tpu_torch.datagen import coco
    from torch_renderer_tpu_torch.opt.creator import (
        CreatorConfig,
        TwoPhaseCreator,
    )

    deformer = _deform_setup()
    with pytest.raises(ValueError, match="CUDA"):
        deformer.fit(torch.Generator().manual_seed(0), n_steps=1,
                     capture=True)
    fitter, meshes, Rs, ts, refs = _color_setup()
    with pytest.raises(ValueError, match="CUDA"):
        fitter.fit(meshes, Rs, ts, refs, n_steps=1, capture=True)
    creator = TwoPhaseCreator(deformer.src, deformer.target_meshes,
                              CreatorConfig(geometry=deformer.config))
    with pytest.raises(ValueError, match="CUDA"):
        creator.geometry_train(torch.Generator().manual_seed(0), n_steps=1,
                               capture=True)
    with pytest.raises(ValueError, match="CUDA"):
        CapturedCall(lambda x: x, "cpu", capture=True)
    with pytest.raises(ValueError, match="CUDA"):
        coco.COCODataGenerator(coco.ObjectLibrary.primitives(level=1),
                               coco.DataGenConfig(image_size=(48, 64)),
                               device="cpu", capture=True)
    with pytest.raises(ValueError, match="CUDA"):
        StepGraph(lambda: None, "cpu", capture=True,
                  generators=(torch.Generator(),))

"""The rank side of tests/test_torch_parallel.py: scenes and cases that run
inside the gloo ranks parallel.launch.run_ranks starts (one spawn for the
whole module). Imports torch and the port only; the test module holds the
results against the JAX package and the port's single-rank calls.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from torch_renderer_tpu_torch.cameras.perspective import PerspectiveCamera
from torch_renderer_tpu_torch.ops.icosphere import icosphere
from torch_renderer_tpu_torch.parallel import (
    all_gather_batch,
    data_parallel_fit,
    make_mesh,
    make_sharded_pose_step,
    render_points_sharded,
    shard_batch,
    soft_silhouette_sharded,
)
from torch_renderer_tpu_torch.structures.meshes import Meshes
from torch_renderer_tpu_torch.structures.pointclouds import Pointclouds

IMAGE = (32, 32)
B = 4
WORLD = 8
CPU = "cpu"


def intrinsics() -> np.ndarray:
    f = 0.8 * IMAGE[0]
    return np.array([[f, 0, IMAGE[1] / 2], [0, f, IMAGE[0] / 2], [0, 0, 1]],
                    np.float32)


def scene(batch: int = B):
    """tests/test_parallel.py's scene: a level-1 icosphere (80 faces) at
    t = (0, 0, 3), batch copies; K tiled over the batch so that every
    camera tensor has the batch axis."""
    verts, faces = icosphere(1)
    meshes = Meshes.from_single(verts, faces, device=CPU).extend(batch)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (batch, 3, 3))
    t = np.tile(np.array([0.0, 0.0, 3.0], np.float32), (batch, 1))
    cam = PerspectiveCamera.from_K(np.tile(intrinsics()[None], (batch, 1, 1)),
                                   IMAGE, R=R, t=t, device=CPU)
    return meshes, cam


def vertex_grad(meshes, fn) -> np.ndarray:
    v = meshes.verts.detach().clone().requires_grad_(True)
    fn(meshes.update_padded(v)).sum().backward()
    return v.grad.numpy()


def point_scene():
    """tests/test_parallel.py's clouds: B=3 of 300 points at z ~ 2.5."""
    Bp, P = 3, 300
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 0.3, (Bp, P, 3)).astype(np.float32)
    pts[..., 2] += 2.5
    feats = rng.uniform(0, 1, (Bp, P, 3)).astype(np.float32)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (Bp, 3, 3)).copy()
    t = np.tile(np.array([0.0, 0.0, 2.5], np.float32), (Bp, 1))
    return pts, feats, R, t


def point_renderers():
    from torch_renderer_tpu_torch.renderer import (
        AlphaPointRender,
        PulsarRenderer,
    )

    K = intrinsics()
    kw = dict(radius=0.05, bin_size=16, max_points_per_bin=128, device=CPU)
    return {"alpha": AlphaPointRender(K, IMAGE, **kw),
            "pulsar": PulsarRenderer(K, IMAGE, **kw)}


def datagen_config():
    from torch_renderer_tpu_torch.datagen.coco import DataGenConfig

    return DataGenConfig(
        image_size=(64, 64), views_per_scene=6, view_chunk=3,
        objects_per_scene=(2, 2), material_mode="vertex",
        normal_maps=True, bin_size=16, max_faces_per_bin=96)


def datagen_render(device_mesh=None) -> dict:
    from torch_renderer_tpu_torch.datagen.coco import (
        COCODataGenerator,
        ObjectLibrary,
    )

    gen = COCODataGenerator(ObjectLibrary.primitives(2, level=1),
                            datagen_config(), device_mesh=device_mesh,
                            device=CPU)
    scene_, _ = gen.sample_scene(np.random.default_rng(9))
    out = gen.render_scene(scene_, np.random.default_rng(3))
    res = {k: out[k] for k in ("rgb", "depth", "segmentation", "normals")}
    res["view_chunk"] = gen.config.view_chunk
    return res


def pose_fit_problem():
    """A B=4 camera pose fit at 32x32 (fragments route, auto budgets) with
    references at the true pose and a perturbed start."""
    from torch_renderer_tpu_torch.opt.pose_fit import (
        CameraPoseFitter,
        PoseFitConfig,
        pose_params_from_Rt,
    )

    meshes, _ = scene()
    fitter = CameraPoseFitter(intrinsics(), IMAGE,
                              PoseFitConfig(lr=1e-2, n_steps=6), device=CPU)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy()
    t = np.tile(np.array([0.0, 0.0, 3.0], np.float32), (B, 1))
    refs = fitter.make_references(meshes, R, t)
    t0 = t + np.array([[0.05, -0.03, 0.1], [0.0, 0.04, -0.05],
                       [-0.04, 0.0, 0.08], [0.02, 0.02, 0.0]], np.float32)
    return fitter, meshes, refs, pose_params_from_Rt(R, t0, device=CPU)


def search_clouds():
    """A pose search's reference cloud (96, 3) and its target, the cloud
    moved by a known pose."""
    from torch_renderer_tpu_torch.transforms.so3 import (
        euler_angles_to_matrix,
        transform_points,
    )

    gen = torch.Generator().manual_seed(6)
    ref = torch.randn((96, 3), generator=gen) * 0.2
    R = euler_angles_to_matrix(torch.tensor([0.3, -0.5, 0.9]), "XYZ")
    return ref, transform_points(R, torch.tensor([0.15, -0.05, 0.2]), ref)


def raises(fn, exc=Exception) -> str | None:
    """The message of the exception fn raises, or None."""
    try:
        fn()
    except exc as e:   # the parent checks its type by the message
        return f"{type(e).__name__}: {e}"
    return None


# ---------------------------------------------------------------------------
# The cases, run on every rank of one 8-rank gloo world
# ---------------------------------------------------------------------------

def silhouette_cases(dm) -> dict:
    from torch_renderer_tpu_torch.rasterize.binning import (
        suggest_active_tiles_fd,
    )
    from torch_renderer_tpu_torch.rasterize.geometry import setup_faces
    from torch_renderer_tpu_torch.rasterize.soft import (
        SOFT_CUTOFF,
        soft_silhouette_streaming,
    )

    meshes, cam = scene()
    kw = dict(pixel_chunk=512, face_chunk=16)
    out = {"streaming": soft_silhouette_sharded(meshes, cam, dm, **kw),
           "grad": vertex_grad(meshes, lambda m: soft_silhouette_sharded(
               m, cam, dm, **kw))}
    # data-parallel: each rank renders its batch slice, one all_gather
    local = shard_batch((meshes, cam), dm)
    out["data_parallel"] = all_gather_batch(
        soft_silhouette_streaming(*local), dm)
    out["pallas"] = soft_silhouette_sharded(meshes, cam, dm, impl="pallas",
                                            faces_per_tile=40)
    act = suggest_active_tiles_fd(setup_faces(meshes, cam), IMAGE, 16,
                                  float(np.sqrt(SOFT_CUTOFF * 1e-4)))
    out["pallas_active"] = soft_silhouette_sharded(
        meshes, cam, dm, impl="pallas", faces_per_tile=40,
        active_tiles=act)
    out["pallas_packed"] = soft_silhouette_sharded(
        meshes, cam, dm, impl="pallas", faces_per_tile=40,
        active_tiles=act, layout="packed", group_lanes=256)
    out["pallas_grad"] = vertex_grad(meshes, lambda m: soft_silhouette_sharded(
        m, cam, dm, impl="pallas", faces_per_tile=40))
    m3, c3 = scene(3)
    out["uneven"] = soft_silhouette_sharded(m3, c3, dm, **kw)
    out["uneven_grad"] = vertex_grad(m3, lambda m: soft_silhouette_sharded(
        m, c3, dm, **kw))
    return out


def pose_step_cases(dm) -> dict:
    from torch_renderer_tpu_torch.opt.pose_fit import pose_params_from_Rt
    from torch_renderer_tpu_torch.rasterize.soft import (
        soft_silhouette_streaming,
    )

    meshes, cam = scene()
    base = PerspectiveCamera.from_K(intrinsics(), IMAGE, device=CPU)
    ref = soft_silhouette_streaming(meshes, cam)
    R0 = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3))
    t0 = np.tile(np.array([0.1, -0.05, 3.2], np.float32), (B, 1))
    params = pose_params_from_Rt(R0, t0, device=CPU)
    step = make_sharded_pose_step(dm, base, 5e-3, pixel_chunk=512,
                                  face_chunk=16)
    state, losses, trail = None, [], []
    for _ in range(5):
        params, state, loss = step(params, state, meshes, ref)
        losses.append(float(loss))
        trail.append(params["t"].clone())
    return {"losses": losses, "t_trail": torch.stack(trail),
            "capture_true": raises(lambda: make_sharded_pose_step(
                dm, base, 5e-3, capture=True), ValueError)}


def search_cases(dm, ref_np, target_np) -> dict:
    from torch_renderer_tpu_torch.opt.pose_search import (
        GMMPoseSearch,
        PoseSearchConfig,
    )
    from torch_renderer_tpu_torch.transforms.so3 import transform_points

    ref = torch.as_tensor(ref_np)
    target = torch.as_tensor(target_np)
    search = GMMPoseSearch(ref, PoseSearchConfig(n_hypotheses=64, n_elite=16,
                                                 n_iters=3))
    out = {"search": search.search(torch.Generator().manual_seed(7), target,
                                   device_mesh=dm)}
    uneven = GMMPoseSearch(ref, PoseSearchConfig(n_hypotheses=30, n_elite=8,
                                                 n_iters=1))
    out["uneven_hypotheses"] = raises(lambda: uneven.search(
        torch.Generator().manual_seed(0), target, device_mesh=dm),
        ValueError)
    eye = torch.eye(3)
    targets = torch.stack([
        target, transform_points(eye, torch.tensor([0.1, 0.0, -0.1]), target),
        transform_points(eye, torch.tensor([-0.2, 0.1, 0.0]), target)])
    batch = GMMPoseSearch(ref, PoseSearchConfig(n_hypotheses=32, n_elite=8,
                                                n_iters=2))
    out["batch"] = batch.search_batch(torch.Generator().manual_seed(11),
                                      targets, device_mesh=dm)
    return out


def icp_cases(dm, data5, data3) -> dict:
    from torch_renderer_tpu_torch.ops.icp import SimilarityTransform
    from torch_renderer_tpu_torch.opt.registration import (
        register_batch_sharded,
    )

    d5 = {k: torch.as_tensor(v) for k, v in data5.items()}
    d3 = {k: torch.as_tensor(v) for k, v in data3.items()}
    init = SimilarityTransform(R=torch.eye(3).expand(3, 3, 3),
                               t=torch.zeros((3, 3)), s=torch.ones(3))
    return {"uneven": register_batch_sharded(d5, dm, max_iterations=12),
            "init": register_batch_sharded(d3, dm, max_iterations=8,
                                           init_transform=init)}


def fit_cases(dm) -> dict:
    fitter, meshes, refs, params0 = pose_fit_problem()
    params, hist = data_parallel_fit(fitter, meshes, refs, params0, dm,
                                     n_steps=6)
    return {"params": params, "history": hist}


def run_all(data5, data3, ref_np, target_np, datagen_dirs) -> dict:
    """Every case of the module on this rank; returns its results."""
    torch.manual_seed(0)
    rank = dist.get_rank()
    dm = make_mesh((4, 2), ("data", "model"))
    out = {"rank": rank, "mesh_shape": tuple(dm.shape),
           "bad_shape": raises(lambda: make_mesh((3, 2)), ValueError),
           "not_a_mesh": raises(lambda: soft_silhouette_sharded(
               *scene(), object()), TypeError)}
    out["sil"] = silhouette_cases(dm)
    meshes, cam = scene()
    for shape in ((2, 4), (8, 1), (1, 8)):
        other = make_mesh(shape, ("data", "model"))
        out[f"sil_{shape[0]}x{shape[1]}"] = soft_silhouette_sharded(
            meshes, cam, other, pixel_chunk=512, face_chunk=16)
    out["pose_step"] = pose_step_cases(dm)
    out["search"] = search_cases(dm, ref_np, target_np)
    out["icp"] = icp_cases(dm, data5, data3)
    out["fit"] = fit_cases(dm)
    out["datagen"] = datagen_render(dm)
    from torch_renderer_tpu_torch.datagen.coco import (
        COCODataGenerator,
        ObjectLibrary,
    )

    gen = COCODataGenerator(ObjectLibrary.primitives(1, level=0),
                            datagen_config(), device_mesh=dm, device=CPU)
    gen.generate(datagen_dirs[rank], 1, rng=np.random.default_rng(0))

    dm8 = make_mesh((8, 1), ("data", "model"))
    pts, feats, R, t = point_scene()
    pcl = Pointclouds(points=torch.as_tensor(pts),
                      num_points=torch.full((3,), 300),
                      features=torch.as_tensor(feats))
    out["points"] = {name: render_points_sharded(r, pcl, R, t, dm8)
                     for name, r in point_renderers().items()}
    from torch_renderer_tpu_torch import bench

    bm, bc, cfg = bench.sharded_scene(1, 64, 1, CPU, make_mesh(
        None, ("data",)))
    step, _ = bench.make_step(bm, bc, cfg=cfg, capture=False)
    v = bm.verts
    for _ in range(3):
        v, _ = step(v)
    out["bench"] = {"verts": all_gather_batch(v, dm8), "start": bm.verts}
    return out


# ---------------------------------------------------------------------------
# The card cases (tests/test_torch_cuda_kernels.py): two ranks, each on a
# card of its own under NCCL or both on cuda:0 under gloo
# ---------------------------------------------------------------------------

def _counted(fn):
    from torch_renderer_tpu_torch.ops import cuda_svd3
    from torch_renderer_tpu_torch.rasterize import (
        cuda_gather,
        cuda_hard,
        cuda_points,
        cuda_soft,
        cuda_untile,
    )

    mods = {"soft_coverage_fwd": (cuda_soft, "FWD_LAUNCHES"),
            "soft_coverage_bwd": (cuda_soft, "BWD_LAUNCHES"),
            "hard_k1": (cuda_hard, "HARD_LAUNCHES"),
            "topk_select": (cuda_hard, "TOPK_LAUNCHES"),
            "points_select": (cuda_points, "POINTS_LAUNCHES"),
            "gather_tiles_fwd": (cuda_gather, "GATHER_FWD_LAUNCHES"),
            "gather_tiles_bwd": (cuda_gather, "GATHER_BWD_LAUNCHES"),
            "untile_scatter": (cuda_untile, "UNTILE_LAUNCHES"),
            "svd3": (cuda_svd3, "SVD3_LAUNCHES")}
    torch.cuda.synchronize()
    before = {k: getattr(m, a) for k, (m, a) in mods.items()}
    out = fn()
    torch.cuda.synchronize()
    return out, {k: getattr(m, a) - before[k] for k, (m, a) in mods.items()}


def card_cases() -> dict:
    """The sharded paths at small sizes on the card, each with its wrapper
    counts on this rank; rank 0 also the single-rank calls."""
    from torch_renderer_tpu_torch.opt.registration import (
        RegisterDataConfig,
        create_register_data,
        register_batch,
        register_batch_sharded,
    )
    from torch_renderer_tpu_torch.rasterize import cuda_soft
    from torch_renderer_tpu_torch.rasterize.geometry import setup_face_planes

    torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    face, data = make_mesh((1, 2)), make_mesh((2, 1))
    out = {"rank": rank}

    meshes, cam = scene()
    meshes, cam = meshes.to(dev), cam.to(dev)

    def sil(render):
        v = meshes.verts.detach().clone().requires_grad_(True)
        a = render(meshes.update_padded(v))
        (g,) = torch.autograd.grad(a.sum(), v)
        return a.detach(), g

    (a, g), counts = _counted(lambda: sil(lambda m: soft_silhouette_sharded(
        m, cam, face, impl="pallas", faces_per_tile=40)))
    out["sil"] = {"alpha": a, "grad": g, "counts": counts}
    if rank == 0:
        out["sil"]["single"] = sil(lambda m: cuda_soft.soft_silhouette_fd(
            setup_face_planes(m, cam), IMAGE, faces_per_tile=80))

    gen = torch.Generator(device=dev).manual_seed(5)
    base = torch.randn((64, 3), generator=gen, device=dev) * 0.2
    d5 = create_register_data(gen, base, RegisterDataConfig(
        n_objects=5, crop_fraction=0.3))
    sol, counts = _counted(lambda: register_batch_sharded(
        d5, data, max_iterations=12))
    out["icp"] = {"t": sol.RTs.t, "R": sol.RTs.R, "rmse": sol.rmse,
                  "counts": counts}
    if rank == 0:
        plain = register_batch(d5, max_iterations=12)
        out["icp"]["single"] = {"t": plain.RTs.t, "R": plain.RTs.R,
                                "rmse": plain.rmse}

    pts, feats, R, t = point_scene()
    pcl = Pointclouds(points=torch.as_tensor(pts, device=dev),
                      num_points=torch.full((3,), 300, device=dev),
                      features=torch.as_tensor(feats, device=dev))
    from torch_renderer_tpu_torch.renderer import AlphaPointRender

    r = AlphaPointRender(intrinsics(), IMAGE, radius=0.05, bin_size=16,
                         max_points_per_bin=128, device=dev)
    img, counts = _counted(lambda: render_points_sharded(r, pcl, R, t, data))
    out["points"] = {"img": img, "counts": counts}
    if rank == 0:
        out["points"]["single"] = r.render(pcl, R, t)

    from torch_renderer_tpu_torch.datagen.coco import (
        COCODataGenerator,
        ObjectLibrary,
    )

    def render(mesh_):
        gen_ = COCODataGenerator(ObjectLibrary.primitives(2, level=1),
                                 datagen_config(), device_mesh=mesh_,
                                 device=dev)
        s, _ = gen_.sample_scene(np.random.default_rng(9))
        o = gen_.render_scene(s, np.random.default_rng(3))
        return {k: o[k] for k in ("rgb", "depth", "segmentation",
                                  "normals")}

    res, counts = _counted(lambda: render(data))
    out["datagen"] = {"out": res, "counts": counts}
    if rank == 0:
        out["datagen"]["single"] = render(None)

    from torch_renderer_tpu_torch.opt.pose_search import (
        GMMPoseSearch,
        PoseSearchConfig,
    )
    from torch_renderer_tpu_torch.transforms.so3 import transform_points

    # search_batch with one target a rank, and (rank 0) each of three
    # targets searched alone from the batch's draws: both are what a rank
    # holding one target runs, and must equal the unsplit batch bit for bit
    ref_pts, target = (torch.as_tensor(x, device=dev)
                       for x in search_clouds())
    targets = torch.stack([transform_points(
        torch.eye(3, device=dev), torch.tensor(s, device=dev), target)
        for s in ([0.0, 0.0, 0.0], [0.1, 0.0, -0.1], [-0.2, 0.1, 0.0])])
    search = GMMPoseSearch(ref_pts, PoseSearchConfig(
        n_hypotheses=64, n_elite=16, n_iters=3))

    def batch(n, mesh_):
        return search.search_batch(torch.Generator(device=dev).manual_seed(
            11), targets[:n], device_mesh=mesh_)

    out["search"] = {"split": batch(2, data)}
    if rank == 0:
        whole = batch(3, None)
        draws = search._draws(torch.Generator(device=dev).manual_seed(11), 3)
        masks = torch.ones(targets.shape[:2], device=dev)
        out["search"].update(
            whole2=batch(2, None), whole3=whole,
            alone=[search._run_targets(targets, masks, draws, [g], None)
                   for g in range(3)])

    out["pose_step"] = card_pose_step(face, dev)
    return out


def card_pose_step(face, dev) -> dict:
    """The sharded pose step on the card for 5 steps in its default form
    (captured under NCCL, eager under gloo) and eagerly (capture=False):
    each form's losses and translations."""
    from torch_renderer_tpu_torch.opt.pose_fit import pose_params_from_Rt

    meshes, cam = scene()
    meshes, cam = meshes.to(dev), cam.to(dev)
    base_cam = PerspectiveCamera.from_K(intrinsics(), IMAGE, device=dev)
    params = pose_params_from_Rt(
        np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)),
        np.tile(np.array([0.1, -0.05, 3.2], np.float32), (B, 1)), dev)
    ref = soft_silhouette_sharded(meshes, cam, face)

    def steps(step):
        p, state, losses, trail = params, None, [], []
        for _ in range(5):
            p, state, loss = step(p, state, meshes, ref)
            losses.append(float(loss))
            trail.append(p["t"])
        return losses, torch.stack(trail)

    losses, trail = steps(make_sharded_pose_step(face, base_cam, 5e-3))
    eager, eager_trail = steps(make_sharded_pose_step(
        face, base_cam, 5e-3, capture=False))
    out = {"losses": losses, "trail": trail, "eager": eager,
           "eager_trail": eager_trail, "backend": dist.get_backend()}
    if dist.get_backend() == "gloo":
        out["capture_true"] = raises(lambda: make_sharded_pose_step(
            face, base_cam, 5e-3, capture=True)(params, None, meshes, ref),
            ValueError)
    return out


def card_pose_step_one_rank() -> dict:
    """card_pose_step on a (1, 1) mesh of this rank alone (a world of one
    under NCCL: the step captured with the gradients' all_reduce
    inside)."""
    return card_pose_step(make_mesh((1, 1)),
                          torch.device("cuda", torch.cuda.current_device()))

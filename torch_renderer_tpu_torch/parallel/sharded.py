"""Rendering and optimization over the ranks of a DeviceMesh (PyTorch
counterpart of ``torch_renderer_tpu.parallel.sharded``).

Two parallel axes (parallel/mesh.py):

  * data-parallel: the batch of (meshes, poses, reference images, clouds)
    is padded to a multiple of the 'data' axis and each rank takes its
    slice; an all_gather returns the whole, whose backward is the rank's
    slice of the gradient.
  * face-parallel ('model' axis): the soft coverage sum S decomposes over
    faces (rasterize/soft.py), so each rank measures its face slice against
    every pixel and ONE all_reduce over 'model' combines them. Its backward
    passes the gradient through unchanged (JAX's psum transposes to an
    identity broadcast).

Every rank passes the same full inputs and gets the full result back, as a
JAX caller does with global arrays. Each rank's backward covers the part
of the inputs it worked on; the inputs' gradients are summed over the
ranks that split them (mesh.sum_grads), so every rank's gradient is the
single-device one.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..cameras.perspective import PerspectiveCamera
from ..rasterize.geometry import FacePlanes, setup_face_planes
from ..rasterize.soft import soft_coverage_sum
from ..structures.meshes import Meshes
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    _rank_slice,
    all_gather_batch,
    all_reduce_sum,
    axis_group,
    axis_index,
    axis_size,
    check_mesh,
    pad_axis_to_multiple,
    pad_batch_to,
    resolve_collective_capture,
    shard_batch,
    sum_grads,
    tree_map,
)


def soft_silhouette_sharded(
    meshes: Meshes,
    camera: PerspectiveCamera,
    device_mesh,
    sigma: float = 1e-4,
    pixel_chunk: int = 8192,
    face_chunk: int = 1024,
    data_axis: str = DATA_AXIS,
    model_axis: str = MODEL_AXIS,
    impl: str = "streaming",
    faces_per_tile: int = 128,
    active_tiles: Optional[int] = None,
    layout: str = "lane",
    group_lanes: Optional[int] = None,
    sum_input_grads: bool = True,
) -> torch.Tensor:
    """Soft silhouette (B, H, W) with faces split over ``model_axis`` and
    the batch over ``data_axis``; every rank returns the whole. Exact (the
    dense streaming oracle's sum); differentiable, and the gradient of the
    inputs on every rank is the single-device gradient.

    Both axes are zero-padded to split evenly: the face axis over the model
    axis (padding faces carry valid=False and add softplus(-1e9 / sigma) =
    0) and the batch over the data axis (padded rows are all-invalid and
    cut from the result). impl="pallas" runs each rank's coverage sum
    through the CUDA kernel pair (rasterize/cuda_soft, its plain versions
    on CPU tensors); size faces_per_tile for the LOCAL face count and
    active_tiles for the LOCAL slice's non-empty tiles (each rank sees only
    its faces). layout and group_lanes are cuda_soft.soft_silhouette_fd's.
    "streaming" runs rasterize/soft.soft_coverage_sum.

    sum_input_grads=False leaves each rank's gradient of the inputs
    partial (its block of rows and faces) for a caller that sums its
    parameters' gradients over the ranks itself, after the backward
    (make_sharded_pose_step): then no collective runs in the backward.
    """
    check_mesh(device_mesh)
    if impl not in ("streaming", "pallas"):
        raise ValueError(f"unknown impl {impl!r}")
    m, d = axis_size(device_mesh, model_axis), axis_size(device_mesh,
                                                         data_axis)
    i, j = axis_index(device_mesh, data_axis), axis_index(device_mesh,
                                                          model_axis)
    # every rank works on its (rows, faces) block of the same inputs: the
    # blocks tile the whole, so the inputs' gradients sum over all ranks
    if sum_input_grads:
        meshes, camera = sum_grads((meshes, camera))
    fp = setup_face_planes(meshes, camera)
    batch = fp.valid.shape[0]
    fp = FacePlanes(*(
        _rank_slice(_rank_slice(
            pad_axis_to_multiple(pad_axis_to_multiple(x, 1, m), 0, d),
            j, m, dim=1), i, d)
        for x in fp))
    image_size = camera.image_size
    if impl == "pallas":
        from ..rasterize.cuda_soft import soft_silhouette_fd

        S = soft_silhouette_fd(
            fp, image_size, sigma=sigma, faces_per_tile=faces_per_tile,
            return_sum=True, active_tiles=active_tiles, layout=layout,
            group_lanes=group_lanes)
    else:
        S = soft_coverage_sum(fp, image_size, sigma=sigma,
                              pixel_chunk=pixel_chunk, face_chunk=face_chunk)
    S = all_reduce_sum(S, device_mesh, model_axis)
    S = all_gather_batch(S, device_mesh, data_axis)
    return (1.0 - torch.exp(-S))[:batch]


def render_points_sharded(renderer, pointclouds, R, tvec, device_mesh,
                          data_axis: str = DATA_AXIS):
    """Point rendering with the cloud batch split over ``data_axis``; every
    rank returns the whole render.

    renderer: any PointsRenderer (AlphaPointRender, NormPointRender,
    PulsarPointRender, PulsarRenderer). Clouds are independent: each rank
    renders its slice of the batch, padded to a multiple of the axis size
    with empty clouds, and one all_gather returns the batch. Auto bin
    budgets are sized from EVERY rank's slice and max-merged (prepare
    with grow=True) before any render, so a denser cloud on another rank
    cannot overflow a shared budget."""
    check_mesh(device_mesh)
    d, i = axis_size(device_mesh, data_axis), axis_index(device_mesh,
                                                         data_axis)
    dev = pointclouds.points.device
    args = (pointclouds, torch.as_tensor(R, dtype=torch.float32, device=dev),
            torch.as_tensor(tvec, dtype=torch.float32, device=dev))
    args = sum_grads(args, axis_group(device_mesh, data_axis)) \
        if d > 1 else args
    B = pointclouds.points.shape[0]
    Bp = -(-B // d) * d
    args, _ = pad_batch_to(args, Bp)
    if getattr(renderer.settings, "bin_size", 0) is None:
        with torch.no_grad():
            for k in range(d):
                renderer.prepare(*tree_map(
                    lambda x: _rank_slice(x, k, d), args), grow=True)
    out = renderer.render(*tree_map(lambda x: _rank_slice(x, i, d), args))
    return all_gather_batch(out, device_mesh, data_axis)[:B]


def data_parallel_fit(fitter, meshes: Meshes, refs, params0, device_mesh,
                      n_steps: Optional[int] = None,
                      data_axis: str = DATA_AXIS, capture=None):
    """CameraPoseFitter.fit with the batch split over ``data_axis``.
    Returns (params, history) like fit(), whole on every rank.

    Each rank fits its slice of the batch: per-item pose parameters need
    no gradient exchange, so the step has no collective and runs captured
    per rank as fit() does (capture as there). Every loss term is a mean
    over the WHOLE batch: each rank's loss is its slice's sum over the
    whole batch's size (and mask count), so Adam sees the single-device
    gradients. The history is those partial sums all-reduced, and the
    parameters are all-gathered, once, after the loop. Auto raster
    budgets are sized from every rank's slice, max-merged. The batch must
    divide by the axis size."""
    check_mesh(device_mesh)
    d = axis_size(device_mesh, data_axis)
    B = meshes.batch_size
    if B % d:
        raise ValueError(f"batch {B} must divide by the '{data_axis}' axis "
                         f"size {d}")
    params0 = {k: torch.as_tensor(v, device=fitter.device)
               for k, v in params0.items()}
    # whole-batch normalizers: every rank holds the full references
    totals = {"batch": B, "npix": refs["mask"].sum().clamp_min(1.0)}
    if fitter.renderer.settings.bin_size is None:
        for k in range(d):
            fitter.prepare(*tree_map(lambda x: _rank_slice(x, k, d),
                                     (meshes, params0)))
    local = shard_batch((meshes, refs, params0), device_mesh, data_axis)
    params, hist = fitter.fit(*local, n_steps, capture=capture,
                              totals=totals)
    params = all_gather_batch(params, device_mesh, data_axis)
    hist = {k: all_reduce_sum(v, device_mesh, data_axis)
            for k, v in hist.items()}
    return params, hist


def sharded_silhouette_loss(
    meshes: Meshes, camera: PerspectiveCamera, ref_sil: torch.Tensor,
    device_mesh, sigma: float = 1e-4, **kw,
) -> torch.Tensor:
    """Mean-L1 silhouette loss on the data + face sharded render
    (0-dim)."""
    sil = soft_silhouette_sharded(meshes, camera, device_mesh, sigma=sigma,
                                  **kw)
    return (sil - ref_sil).abs().mean()


class ShardedPoseState:
    """The state of make_sharded_pose_step's loop: the parameters it
    updates in place, their torch.optim.Adam, and (captured) the static
    inputs and the step's graph."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in params.items()}
        cuda = next(iter(self.params.values())).is_cuda
        self.optimizer = torch.optim.Adam(list(self.params.values()), lr=lr,
                                          capturable=cuda)
        self.inputs = None
        self.graph = None


def make_sharded_pose_step(
    device_mesh,
    base_camera: PerspectiveCamera,
    lr: float = 1e-3,
    sigma: float = 1e-4,
    pixel_chunk: int = 8192,
    face_chunk: int = 512,
    capture=None,
):
    """The data + face sharded pose-optimization train step (the
    multi-card training path), with torch.optim.Adam at ``lr`` in place of
    the JAX package's optax optimizer.

    Parameters {t (B, 3), quat (B, 4)}, one pose per batch item; the
    silhouette is rendered with faces split over 'model' and the batch
    over 'data' (soft_silhouette_sharded), and every rank takes the same
    Adam step on the whole parameters. Returns step(params, state, meshes,
    ref_sil) -> (params, state, loss): state None starts a new Adam at
    params, a state returned by an earlier call carries on from it (params
    are copied in when they are other tensors).

    capture: the step has collectives inside, so a CUDA graph captures it
    under NCCL only (mesh.resolve_collective_capture): None replays one
    captured graph a step under NCCL on the card and runs eagerly under
    gloo; True under gloo raises ValueError. The backward holds no
    collective: each rank's covers its block of rows and faces of the
    silhouette term and all of the replicated quaternion term (counted
    1 / ranks), and one all_reduce of the parameters' gradients after it
    sums them."""
    import torch.distributed as dist

    from ..transforms.so3 import quaternion_normalize, quaternion_to_matrix
    from ..utils.graph import StepGraph

    check_mesh(device_mesh)
    ranks = device_mesh.size()
    captured = resolve_collective_capture(capture, base_camera.fx.device,
                                          device_mesh)

    def loss_terms(params, meshes, ref_sil):
        R = quaternion_to_matrix(quaternion_normalize(params["quat"]))
        cam = base_camera.replace_pose(R, params["t"])
        sil = soft_silhouette_sharded(
            meshes, cam, device_mesh, sigma=sigma, pixel_chunk=pixel_chunk,
            face_chunk=face_chunk, sum_input_grads=False)
        qn = torch.linalg.norm(params["quat"], dim=-1)
        return (sil - ref_sil).abs().mean(), ((qn - 1.0) ** 2).mean()

    def body(state):
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        fit, reg = loss_terms(state.params, *state.inputs)
        (fit + reg / ranks).backward()
        for p in state.params.values():
            dist.all_reduce(p.grad)
        opt.step()
        return (fit + reg).detach()

    def step(params, state, meshes, ref_sil):
        if state is None:
            state = ShardedPoseState(params, lr)
        else:
            with torch.no_grad():
                for k, v in params.items():
                    if v is not state.params[k]:
                        state.params[k].copy_(v)
        if not captured:
            state.inputs = (meshes, ref_sil)
            loss = body(state)
        else:
            if state.graph is None:
                state.inputs = (tree_map(torch.clone, meshes),
                                ref_sil.clone())
                state.graph = StepGraph(lambda: body(state),
                                        state.params["t"].device, True)
            else:
                with torch.no_grad():
                    static_m, static_ref = state.inputs
                    static_m.verts.copy_(meshes.verts)
                    static_m.faces.copy_(meshes.faces)
                    static_ref.copy_(ref_sil)
            loss = state.graph().clone()
        return ({k: v.detach().clone() for k, v in state.params.items()},
                state, loss)

    return step

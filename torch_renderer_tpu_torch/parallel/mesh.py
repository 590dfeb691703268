"""Device meshes over torch.distributed ranks, and batch sharding helpers
(PyTorch counterpart of ``torch_renderer_tpu.parallel.mesh``).

The JAX package runs one process over a ``jax.sharding.Mesh``. The port
runs one process per card under torch.distributed (``parallel/launch.py``
starts them, or ``torchrun`` does) and names the axes of the ranks with a
``torch.distributed.device_mesh.DeviceMesh``:

  * 'data'  axis: shards the batch of (meshes, poses, views, objects,
    hypotheses); every item is independent.
  * 'model' axis: shards the FACE axis of the soft silhouette, whose
    coverage sum decomposes over faces; one all_reduce over 'model'
    combines the face-partial sums (parallel/sharded.py).

Every rank calls a sharded entry point with the same full inputs, as a JAX
caller passes global arrays; each rank computes its slice, and collectives
give every rank the full result. Where JAX places an array with a
``NamedSharding``, a rank here holds its slice of it (``shard_batch``) or
all of it (``replicate``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the dtypes every backend's collectives move; others travel as their
# bytes (a bit-for-bit view along the last dim, not a cast)
_WIRE_SAFE = (torch.float32, torch.float64, torch.float16, torch.int32,
              torch.int64, torch.uint8, torch.int8)


def check_mesh(device_mesh) -> None:
    """TypeError unless device_mesh is a DeviceMesh (make_mesh's)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(device_mesh, DeviceMesh):
        raise TypeError(
            "device_mesh must be a torch.distributed.device_mesh.DeviceMesh "
            f"(parallel.make_mesh); got {type(device_mesh).__name__}")


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS),
    devices=None,
):
    """The ranks of the initialized process group as a DeviceMesh with
    named axes. Default: every rank on 'data', 1 on the other axes.

    shape=(d, m) splits the world's ranks into d-way data x m-way face
    parallelism; d * m must equal the world size (ValueError otherwise).
    devices: the mesh's device type, "cuda" or "cpu" (default: "cuda"
    when the group's backend is NCCL or a card is visible). Needs a
    process group: RuntimeError without one (start the ranks with
    parallel.launch.run_ranks or torchrun); there is no mesh of one
    without a group."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized torch.distributed process "
            "group: start the ranks with parallel.launch.run_ranks (or "
            "torchrun) and build the mesh inside them")
    n = dist.get_world_size()
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axis names "
                         f"{axis_names}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    if devices is None:
        devices = "cuda" if (dist.get_backend() == "nccl"
                             or torch.cuda.is_available()) else "cpu"
    return init_device_mesh(str(devices), shape, mesh_dim_names=axis_names)


def data_mesh(axis: str = DATA_AXIS, devices=None):
    """1-axis mesh over every rank (the bench's and the batch app's
    batch-axis sharding)."""
    return make_mesh(None, (axis,), devices)


def axis_size(device_mesh, axis: str) -> int:
    """The number of ranks along ``axis``; 1 for an axis the mesh lacks."""
    names = device_mesh.mesh_dim_names or ()
    return device_mesh.size(names.index(axis)) if axis in names else 1


def axis_index(device_mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``; 0 for an axis the mesh
    lacks."""
    names = device_mesh.mesh_dim_names or ()
    return device_mesh.get_local_rank(axis) if axis in names else 0


def axis_group(device_mesh, axis: str):
    """The process group of this rank's line along ``axis`` (None for an
    axis the mesh lacks)."""
    names = device_mesh.mesh_dim_names or ()
    return device_mesh.get_group(axis) if axis in names else None


def resolve_collective_capture(capture, device, device_mesh) -> bool:
    """utils.graph.resolve_capture for a step with collectives inside: a
    CUDA graph captures NCCL's collectives, not gloo's. Under gloo
    capture=None runs eagerly and capture=True raises ValueError. When it
    resolves to a capture, every group of the mesh has run a collective
    first (NCCL sets a communicator up at its first)."""
    from ..utils.graph import resolve_capture

    backend = dist.get_backend()
    if backend != "nccl":
        if capture:
            raise ValueError(
                "capture=True needs the NCCL backend: a CUDA graph cannot "
                f"capture {backend}'s collectives")
        return False
    captured = resolve_capture(capture, device)
    if captured:
        # NCCL sets up a group's communicator at its first collective:
        # do that here, outside the warm-up and the capture
        one = torch.zeros(1, device=device)
        for group in [None] + [device_mesh.get_group(n)
                               for n in device_mesh.mesh_dim_names]:
            dist.all_reduce(one, group=group)
    return captured


# ---------------------------------------------------------------------------
# Trees of tensors
# ---------------------------------------------------------------------------

def tree_map(fn, tree):
    """fn applied to every tensor of a tree of dicts, lists, tuples,
    NamedTuples and dataclasses (Meshes, PerspectiveCamera, Pointclouds,
    ...); other leaves (ints, None, strings) are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def data_specs(tree, axis: str = DATA_AXIS):
    """Per tensor, the spec of a batch-parallel split: a tuple (axis, None,
    ...) of the tensor's rank, as JAX's PartitionSpec(axis, None, ...). A
    rank holds the tensor's slice along dim 0 (shard_batch)."""
    return tree_map(lambda x: (axis,) + (None,) * (x.ndim - 1), tree)


def batch_spec(device_mesh, ndim: int, axis: str = DATA_AXIS):
    """The DTensor placements of a tensor of rank ``ndim`` split along dim
    0 over ``axis`` and replicated over the mesh's other axes (JAX's
    NamedSharding(mesh, P(axis, None, ...))); a rank holds its slice of
    dim 0."""
    from torch.distributed.tensor import Replicate, Shard

    del ndim   # a DTensor placement names the split dim, not the rank
    return tuple(Shard(0) if name == axis else Replicate()
                 for name in device_mesh.mesh_dim_names)


def _rank_slice(x: torch.Tensor, index: int, parts: int, dim: int = 0):
    n = x.shape[dim]
    if n % parts:
        raise ValueError(f"dim {dim} of size {n} does not split evenly over "
                         f"{parts} ranks (pad it with pad_batch_to)")
    step = n // parts
    return x.narrow(dim, index * step, step)


def shard_batch(tree, device_mesh, axis: str = DATA_AXIS):
    """This rank's slice of every tensor's leading (batch) dim along
    ``axis`` (its part of JAX's shard_batch placement); 0-dim tensors stay
    whole. Leading dims must divide by the axis size."""
    d, i = axis_size(device_mesh, axis), axis_index(device_mesh, axis)
    return tree_map(lambda x: x if x.ndim == 0 else _rank_slice(x, i, d),
                    tree)


def replicate(tree, device_mesh):
    """Every rank holds every tensor whole (JAX's fully replicated
    placement): the tree, unchanged."""
    check_mesh(device_mesh)
    return tree


def pad_batch_to(tree, n: int):
    """Zero-pad every tensor's leading dim up to n (so it shards evenly);
    returns (padded_tree, original_batch)."""
    b = None

    def pad(x):
        nonlocal b
        b = x.shape[0] if b is None else b
        if x.shape[0] == n:
            return x
        zeros = x.new_zeros((n - x.shape[0],) + tuple(x.shape[1:]))
        return torch.cat([x, zeros])

    return tree_map(pad, tree), b


def pad_axis_to_multiple(x: torch.Tensor, axis: int,
                         multiple: int) -> torch.Tensor:
    """Pad ``axis`` of x with zeros up to the next multiple."""
    size = x.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return x
    shape = list(x.shape)
    shape[axis] = target - size
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


# ---------------------------------------------------------------------------
# Collectives with their autograd rules
# ---------------------------------------------------------------------------

def _gather(x: torch.Tensor, group, parts: int) -> torch.Tensor:
    raw = x.dtype not in _WIRE_SAFE
    y = x.contiguous()
    if raw:
        y = y.view(torch.uint8) if y.ndim else y.reshape(1).view(torch.uint8)
    out = [torch.empty_like(y) for _ in range(parts)]
    dist.all_gather(out, y, group=group)
    out = torch.cat(out)
    return out.view(x.dtype) if raw else out


class _AllGatherBatch(torch.autograd.Function):
    """The ranks' slices along dim 0, concatenated in the axis' order; the
    backward keeps this rank's slice of the incoming gradient (every rank
    holds the same loss of the whole)."""

    @staticmethod
    def forward(ctx, x, group, parts, index):
        ctx.parts, ctx.index = parts, index
        return _gather(x, group, parts)

    @staticmethod
    def backward(ctx, g):
        return _rank_slice(g, ctx.index, ctx.parts), None, None, None


def all_gather_batch(tree, device_mesh, axis: str = DATA_AXIS):
    """Every tensor's slices along dim 0 from the ranks of ``axis``,
    concatenated (the inverse of shard_batch); differentiable, its
    backward this rank's slice of the gradient. An axis of one rank
    returns the tree as it is."""
    d = axis_size(device_mesh, axis)
    if d == 1:
        return tree
    group, i = axis_group(device_mesh, axis), axis_index(device_mesh, axis)

    def gather(x):
        if x.requires_grad:
            return _AllGatherBatch.apply(x, group, d, i)
        return _gather(x, group, d)

    return tree_map(gather, tree)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the backward passes the gradient through
    unchanged (JAX's psum transposes to an identity broadcast). Every rank
    of the group holds the same replicated loss downstream, so all-reducing
    the gradient again, as torch.distributed.nn.functional.all_reduce does,
    would scale it by the group's size."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x: torch.Tensor, device_mesh, axis: str) -> torch.Tensor:
    """x summed over the ranks of ``axis``, with an identity backward."""
    if axis_size(device_mesh, axis) == 1:
        return x
    return _AllReduceSum.apply(x, axis_group(device_mesh, axis))


class _SumGrads(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over a group. It
    marks where every rank takes the same full input and works on its own
    part: each rank's gradient covers its part, and their sum is the
    gradient of the whole."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_grads(tree, group=None):
    """Every tensor that requires grad, with a backward that all-reduces
    its gradient over ``group`` (default: every rank); others unchanged."""
    return tree_map(lambda x: _SumGrads.apply(x, group)
                    if x.requires_grad else x, tree)

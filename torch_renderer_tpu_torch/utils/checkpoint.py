"""Checkpoint and resume of optimization state (PyTorch counterpart of
``torch_renderer_tpu.utils.checkpoint``).

``save_checkpoint`` flattens a tree of tensors (dicts, lists, tuples, and
a ``torch.optim`` optimizer's ``state_dict()``) into an ``.npz`` with the
JAX package's keys (``leaf_0``, ``leaf_1``, ... in flattening order, and
``__step__``); ``load_checkpoint`` restores it into the structure of a
template, so a resumed fit continues exactly. The JAX package's orbax
pair becomes ``torch.distributed.checkpoint`` (a directory layout, in
torch itself; it needs no process group). ``export_mesh_snapshot`` writes
one mesh of a batch as OBJ (the reference's periodic save_obj snapshots).
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import numpy as np
import torch


def _flatten(tree) -> Tuple[list, Any]:
    """The tree's leaves in order, and a function that rebuilds the tree
    from a list of leaves. Dicts flatten in sorted key order (as a JAX
    pytree does); tensors, numpy arrays and numbers are leaves; None and
    strings stay in the structure."""
    if isinstance(tree, dict):
        keys = sorted(tree, key=str)
        parts = [_flatten(tree[k]) for k in keys]

        def rebuild(leaves):
            out, i = {}, 0
            for k, (lv, rb) in zip(keys, parts):
                out[k] = rb(leaves[i:i + len(lv)])
                i += len(lv)
            return type(tree)(out) if type(tree) is not dict else out

        return [x for lv, _ in parts for x in lv], rebuild
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]

        def rebuild(leaves):
            out, i = [], 0
            for lv, rb in parts:
                out.append(rb(leaves[i:i + len(lv)]))
                i += len(lv)
            if isinstance(tree, tuple) and hasattr(tree, "_fields"):
                return type(tree)(*out)
            return type(tree)(out)

        return [x for lv, _ in parts for x in lv], rebuild
    if tree is None or isinstance(tree, str):
        return [], lambda leaves: tree
    return [tree], lambda leaves: leaves[0]


def _like(value: np.ndarray, template):
    """A loaded leaf in the template leaf's kind: a tensor keeps its dtype
    and device, a Python number its type."""
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(value, dtype=template.dtype,
                               device=template.device)
    if isinstance(template, (bool, int, float)):
        return type(template)(value)
    return value


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path: str, tree: Any, step: Optional[int] = None) -> None:
    """Save a tree of tensors to ``path`` (.npz appended if missing)."""
    leaves, _ = _flatten(tree)
    payload = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
    if step is not None:
        payload["__step__"] = np.asarray(step)
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **payload)


def load_checkpoint(path: str, like: Any) -> Tuple[Any, Optional[int]]:
    """Restore a tree saved by save_checkpoint. ``like`` supplies the
    structure and each leaf's dtype and device (e.g. freshly made params
    and an optimizer's state_dict() after one step, whose state exists).
    Returns (tree, step)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        templates, rebuild = _flatten(like)
        leaves = [_like(data[f"leaf_{i}"], t)
                  for i, t in enumerate(templates)]
        step = int(data["__step__"]) if "__step__" in data else None
    return rebuild(leaves), step


def save_checkpoint_dcp(path: str, tree: Any) -> None:
    """Save a dict of tensors (e.g. {"params": ..., "optimizer":
    opt.state_dict()}) with torch.distributed.checkpoint: a directory of
    shards and metadata (the JAX package's orbax layout's counterpart).
    Under a process group every rank writes its part."""
    import torch.distributed.checkpoint as dcp

    dcp.save(tree, checkpoint_id=os.path.abspath(path))


def load_checkpoint_dcp(path: str, like: Any) -> Any:
    """Load a save_checkpoint_dcp directory in place into ``like`` (a dict
    of tensors of the saved shapes) and return it."""
    import torch.distributed.checkpoint as dcp

    dcp.load(like, checkpoint_id=os.path.abspath(path))
    return like


def export_mesh_snapshot(path: str, meshes, index: int = 0,
                         verts_rgb=None) -> None:
    """OBJ snapshot of one mesh of a padded batch (the reference's periodic
    save_obj checkpoints), through io.obj.save_obj."""
    from ..io.obj import save_obj

    v, f = meshes.detach_to_lists()[index]
    rgb = None if verts_rgb is None else _host(verts_rgb)[: v.shape[0]]
    save_obj(path, v, f, verts_rgb=rgb)

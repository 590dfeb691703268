"""Mesh regularization losses on a topology built once (PyTorch counterpart
of ``torch_renderer_tpu.ops.mesh_losses``; pytorch3d's mesh_edge_loss,
uniform mesh_laplacian_smoothing and mesh_normal_consistency).

The topology (unique edges, face pairs sharing an edge, vertex degrees) is
constant over a fit, so it is extracted once on the host, in numpy, into
padded index tensors; each loss is then a masked gather and scatter-add on
the device. The JAX package's one-hot row gathers (``ops.rowops``) are a TPU
workaround and are not carried over.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..structures.meshes import Meshes


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    edges: torch.Tensor       # (B, E, 2) int64 unique undirected edges (0-pad)
    num_edges: torch.Tensor   # (B,) int64
    adj: torch.Tensor         # (B, A, 4) int64 [v0, v1, opp_a, opp_b] per
    #                           face pair sharing the edge (v0, v1)
    num_adj: torch.Tensor     # (B,) int64
    degree: torch.Tensor      # (B, V) float32 vertex degrees (0 when padded)

    def edge_mask(self) -> torch.Tensor:
        idx = torch.arange(self.edges.shape[1], device=self.edges.device)
        return (idx[None] < self.num_edges[:, None]).to(torch.float32)

    def adj_mask(self) -> torch.Tensor:
        idx = torch.arange(self.adj.shape[1], device=self.adj.device)
        return (idx[None] < self.num_adj[:, None]).to(torch.float32)


def build_topology(meshes: Meshes) -> MeshTopology:
    """Topology of a padded Meshes batch, extracted on the host (numpy) and
    placed on the meshes' device."""
    faces_np = meshes.faces.cpu().numpy()
    nf = meshes.num_faces.cpu().numpy()
    V, B = meshes.max_verts, meshes.batch_size
    all_edges, all_adj, degrees = [], [], []
    for b in range(B):
        f = faces_np[b, :nf[b]].astype(np.int64)
        e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        e.sort(axis=1)
        opp = np.concatenate([f[:, 2], f[:, 0], f[:, 1]])   # third vertex
        uniq, inv = np.unique(e, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        all_edges.append(uniq)
        deg = np.zeros(V, np.float32)
        np.add.at(deg, uniq[:, 0], 1)
        np.add.at(deg, uniq[:, 1], 1)
        degrees.append(deg)
        # every pair of faces on one edge (2 on a manifold, 0 on a boundary)
        order = np.argsort(inv, kind="stable")
        inv_s, opp_s = inv[order], opp[order]
        starts = np.flatnonzero(np.r_[True, inv_s[1:] != inv_s[:-1]])
        ends = np.r_[starts[1:], len(inv_s)]
        adj = []
        for s0, s1 in zip(starts, ends):
            group = opp_s[s0:s1]
            v0, v1 = uniq[inv_s[s0]]
            for x in range(len(group)):
                for y in range(x + 1, len(group)):
                    adj.append([v0, v1, group[x], group[y]])
        all_adj.append(np.asarray(adj, np.int64).reshape(-1, 4))

    E = max(e.shape[0] for e in all_edges)
    A = max(max(a.shape[0] for a in all_adj), 1)

    def pad(a, n):
        out = np.zeros((n,) + a.shape[1:], np.int64)
        out[:a.shape[0]] = a
        return out

    dev = meshes.device
    return MeshTopology(
        edges=torch.as_tensor(np.stack([pad(e, E) for e in all_edges]),
                              device=dev),
        num_edges=torch.tensor([e.shape[0] for e in all_edges], device=dev),
        adj=torch.as_tensor(np.stack([pad(a, A) for a in all_adj]),
                            device=dev),
        num_adj=torch.tensor([a.shape[0] for a in all_adj], device=dev),
        degree=torch.as_tensor(np.stack(degrees), device=dev),
    )


def _rows(verts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """verts (B, V, 3), idx (B, N) -> (B, N, 3)."""
    return verts.gather(1, idx[..., None].expand(*idx.shape, 3))


def mesh_edge_loss(meshes: Meshes, topo: MeshTopology,
                   target_length: float = 0.0) -> torch.Tensor:
    """Mean squared deviation of edge lengths from target_length, averaged
    over each mesh's edges, then over the batch."""
    d = _rows(meshes.verts, topo.edges[..., 0]) \
        - _rows(meshes.verts, topo.edges[..., 1])
    lens = torch.sqrt((d * d).sum(-1) + 1e-12)                  # (B, E)
    ne = topo.num_edges.to(torch.float32).clamp_min(1.0)
    per = (((lens - target_length) ** 2) * topo.edge_mask()).sum(-1) / ne
    return per.mean()


def mesh_laplacian_smoothing(meshes: Meshes,
                             topo: MeshTopology) -> torch.Tensor:
    """Uniform Laplacian magnitude: mean_i |(1/deg_i) sum_j v_j - v_i| over
    vertices with neighbours, averaged over the batch."""
    verts = meshes.verts
    e0, e1 = topo.edges[..., 0], topo.edges[..., 1]
    w = topo.edge_mask()[..., None]
    idx = lambda e: e[..., None].expand(*e.shape, 3)  # noqa: E731
    acc = torch.zeros_like(verts)
    acc = acc.scatter_add(1, idx(e0), _rows(verts, e1) * w)
    acc = acc.scatter_add(1, idx(e1), _rows(verts, e0) * w)
    lap = acc / topo.degree.clamp_min(1.0)[..., None] - verts
    norm = torch.sqrt((lap * lap).sum(-1) + 1e-12)
    live = (topo.degree > 0).to(verts.dtype)
    per = (norm * live).sum(-1) / live.sum(-1).clamp_min(1.0)
    return per.mean()


def mesh_normal_consistency(meshes: Meshes,
                            topo: MeshTopology) -> torch.Tensor:
    """Mean (1 - cos) between the normals of faces sharing an edge. For the
    pair on edge (v0, v1) with opposite vertices a, b: n1 = (v1 - v0) x
    (a - v0), n2 = -(v1 - v0) x (b - v0); a flat pair gives 0."""
    g = [_rows(meshes.verts, topo.adj[..., k]) for k in range(4)]
    e = g[1] - g[0]
    n1 = torch.linalg.cross(e, g[2] - g[0])
    n2 = -torch.linalg.cross(e, g[3] - g[0])
    cos = (n1 * n2).sum(-1) / (torch.linalg.norm(n1, dim=-1)
                               * torch.linalg.norm(n2, dim=-1)).clamp_min(1e-12)
    m = topo.adj_mask()
    per = ((1.0 - cos) * m).sum(-1) / m.sum(-1).clamp_min(1.0)
    return per.mean()

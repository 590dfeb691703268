"""Soft silhouette: the public entry, its plain tile-binned route and the
dense streaming oracle (PyTorch counterpart of
``torch_renderer_tpu.rasterize.soft``).

SoftRas coverage alpha(p) = 1 - prod_f (1 - sigmoid(-d_f(p)/sigma)) is, in
log space, a sum: alpha(p) = 1 - exp(-sum_f softplus(-d_f(p)/sigma)), where
d_f is the signed squared distance from pixel p to face f (negative inside).

  * soft_silhouette: meshes + camera -> (B, H, W) through the CUDA kernel
    pair (impl="pallas", rasterize/cuda_soft.py) or the plain route
    (impl="binned"); "auto" picks the kernels for CUDA tensors.
  * soft_silhouette_binned: faces bucketed into tiles by padded bbox, each
    pixel summed over its tile's candidates, in plain PyTorch.
  * soft_silhouette_streaming / soft_coverage_sum: every (pixel, face) pair
    in bounded chunks, with no per-tile face cap; the exact oracle.

Every function that takes face data accepts FacePlanes or FaceRasterData.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as nnf
from torch.utils.checkpoint import checkpoint

from ..cameras.perspective import PerspectiveCamera
from ..structures.meshes import Meshes
from .geometry import FacePlanes, channel_edge_bary, setup_face_planes

# softplus(-d2/sigma) < 2e-7 once d2 > SOFT_CUTOFF * sigma: beyond this a face
# contributes nothing, so bins are padded by sqrt(SOFT_CUTOFF * sigma).
SOFT_CUTOFF = 16.0


def pixel_coords_raster(image_size, device=None) -> torch.Tensor:
    """Raster-space coordinates of all pixel centers: (H*W, 2), row-major."""
    H, W = image_size
    s = min(H, W) / 2.0
    v = (torch.arange(H, dtype=torch.float32, device=device) + 0.5 - H / 2.0) / s
    u = (torch.arange(W, dtype=torch.float32, device=device) + 0.5 - W / 2.0) / s
    yy, xx = torch.meshgrid(v, u, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)


def _corners(fd):
    """((x0, x1, x2), (y0, y1, y2)) corner channels (B, F) of FacePlanes or
    FaceRasterData (told apart by its corner tensor ``q``)."""
    if hasattr(fd, "q"):
        return (tuple(fd.q[..., k, 0] for k in range(3)),
                tuple(fd.q[..., k, 1] for k in range(3)))
    return (fd.x0, fd.x1, fd.x2), (fd.y0, fd.y1, fd.y2)


def _min_edge_dist2(px, py, qx, qy):
    """Min over the three edges of the clamped point-to-segment squared
    distance, >= 0; 1/len2 once per face (the soft rounding family)."""
    d2 = None
    for a, b in ((0, 1), (1, 2), (2, 0)):
        gx = qx[b] - qx[a]
        gy = qy[b] - qy[a]
        wx = px - qx[a]
        wy = py - qy[a]
        len2 = (gx * gx + gy * gy).clamp_min(1e-12)
        wg = wx * gx + wy * gy
        t = (wg * (1.0 / len2)).clamp(0.0, 1.0)
        dd = wx * wx + wy * wy - 2.0 * t * wg + t * t * len2
        d2 = dd if d2 is None else torch.minimum(d2, dd)
    return d2.clamp_min(0.0)


def signed_dist2(pix_h, pix, q, abc, area2, valid):
    """Signed squared pixel-to-face distance (negative inside), broadcasting
    over any leading dims (FaceRasterData's tensors).

    pix_h (..., P, 3) homogeneous raster coords, pix (..., P, 2);
    q (..., Fc, 3, 2), abc (..., Fc, 3, 3), area2 (..., Fc), valid (..., Fc).
    Returns (..., P, Fc); invalid faces get +1e9."""
    e = torch.einsum("...pc,...fkc->...pfk", pix_h, abc)
    safe = torch.where(area2.abs() > 1e-12, area2, torch.ones_like(area2))
    inside = (e / safe[..., None, :, None] >= 0.0).all(-1)
    px, py = pix[..., :, None, 0], pix[..., :, None, 1]   # (..., P, 1)
    qx = [q[..., None, :, k, 0] for k in range(3)]          # (..., 1, Fc)
    qy = [q[..., None, :, k, 1] for k in range(3)]
    d2 = _min_edge_dist2(px, py, qx, qy)
    signed = torch.where(inside, -d2, d2)
    return torch.where(valid[..., None, :], signed,
                       torch.full_like(signed, 1e9))


def _signed_dist2(px, py, qx, qy, area2, valid):
    """Signed squared distance (B, P, Fc) from pixels (1, P, 1) to faces
    (B, 1, Fc); invalid faces get +1e9. The inside test is the barycentric
    one of the JAX streaming oracle: every edge function over area2 >= 0."""
    safe_area = torch.where(area2.abs() > 1e-12, area2, torch.ones_like(area2))
    inside = None
    for a, b in ((0, 1), (1, 2), (2, 0)):
        # edge function of the edge opposite the third corner, over area2
        in_e = ((qx[b] - qx[a]) * (py - qy[a])
                - (qy[b] - qy[a]) * (px - qx[a])) / safe_area >= 0.0
        inside = in_e if inside is None else inside & in_e
    d2 = _min_edge_dist2(px, py, qx, qy)
    signed = torch.where(inside, -d2, d2)
    return torch.where(valid, signed, torch.full_like(signed, 1e9))


# ---------------------------------------------------------------------------
# Tile-binned plain route
# ---------------------------------------------------------------------------

def soft_silhouette_binned(fd, image_size, sigma: float = 1e-4,
                           tile: int = 16, faces_per_tile: int = 256,
                           tile_chunk: int = 128) -> torch.Tensor:
    """Tile-binned soft coverage (B, H, W) in plain PyTorch: every
    non-empty tile gets a slot (none is dropped), and a tile sums over its
    first min(faces_per_tile, F) candidates in face-id order. Tiles are
    evaluated tile_chunk at a time, each chunk recomputed in the backward
    (torch.utils.checkpoint), so memory stays bounded at full size."""
    from .binning import (
        bin_faces_active,
        scatter_active,
        slot_faces,
        tile_grid,
        tile_pixel_coords,
        untile_image,
    )

    qx_all, qy_all = _corners(fd)
    B, F = qx_all[0].shape
    device = qx_all[0].device
    TH, TW, _ = tile_grid(image_size, tile)
    pad = math.sqrt(SOFT_CUTOFF * sigma)
    bins = bin_faces_active(fd, image_size, tile, pad, TH * TW)
    K = min(faces_per_tile, F)
    A = bins.count.shape[1]
    idx = slot_faces(bins, K).reshape(B, A * K, 1).expand(B, A * K, 6)
    planes = torch.stack(qx_all + qy_all, dim=-1)                # (B, F, 6)
    slab = planes.gather(1, idx).reshape(B * A, K, 6)
    live = (torch.arange(K, device=device)
            < bins.count.reshape(B * A, 1))                      # (N, K)
    origin = bins.origin.reshape(B * A, 2)
    local = tile_pixel_coords(image_size, tile, device)          # (tp, 2)
    inv_sigma = 1.0 / sigma

    def per_chunk(slab_c, live_c, origin_c):
        px = (local[None, :, 0] + origin_c[:, 0:1])[..., None]  # (c, tp, 1)
        py = (local[None, :, 1] + origin_c[:, 1:2])[..., None]
        qx = [slab_c[:, None, :, k] for k in range(3)]          # (c, 1, K)
        qy = [slab_c[:, None, :, 3 + k] for k in range(3)]
        _, inside = channel_edge_bary(px, py, qx, qy)
        d2 = _min_edge_dist2(px, py, qx, qy)
        d = torch.where(inside, -d2, d2)
        d = torch.where(live_c[:, None, :], d, torch.full_like(d, 1e9))
        return nnf.softplus(-d * inv_sigma).sum(-1)             # (c, tp)

    S = torch.cat([
        checkpoint(per_chunk, slab[n0:n0 + tile_chunk],
                   live[n0:n0 + tile_chunk], origin[n0:n0 + tile_chunk],
                   use_reentrant=False)
        for n0 in range(0, B * A, tile_chunk)])
    per_tile = scatter_active(S.reshape(B, A, -1), bins)         # (B, T, tp)
    return untile_image(1.0 - torch.exp(-per_tile), image_size, tile,
                        bins.n_tiles_hw)


# ---------------------------------------------------------------------------
# Dense streaming path (exact oracle, no per-tile face cap)
# ---------------------------------------------------------------------------

def soft_coverage_sum(fd, image_size, sigma: float = 1e-4,
                      pixel_chunk: int = 8192,
                      face_chunk: int = 1024) -> torch.Tensor:
    """The log-space coverage sum S (B, H, W): alpha = 1 - exp(-S). S is a
    plain sum over faces, so it adds up across face shards."""
    return soft_silhouette_streaming_face_data(
        fd, image_size, sigma=sigma, pixel_chunk=pixel_chunk,
        face_chunk=face_chunk, _return_sum=True)


def soft_silhouette_streaming_face_data(
    fd,
    image_size,
    sigma: float = 1e-4,
    pixel_chunk: int = 8192,
    face_chunk: int = 1024,
    _return_sum: bool = False,
) -> torch.Tensor:
    """Soft coverage (B, H, W), dense over every face, chunked over pixels
    and faces."""
    H, W = image_size
    qx_all, qy_all = _corners(fd)
    B, F = qx_all[0].shape
    device = qx_all[0].device
    pix = pixel_coords_raster((H, W), device)
    inv_sigma = 1.0 / sigma

    rows = []
    for p0 in range(0, H * W, pixel_chunk):
        px = pix[None, p0:p0 + pixel_chunk, 0, None]          # (1, P, 1)
        py = pix[None, p0:p0 + pixel_chunk, 1, None]
        S = torch.zeros((B, px.shape[1]), dtype=torch.float32, device=device)
        for f0 in range(0, F, face_chunk):
            sl = slice(f0, f0 + face_chunk)
            qx = [q[:, None, sl] for q in qx_all]              # (B, 1, Fc)
            qy = [q[:, None, sl] for q in qy_all]
            area2 = ((qx[1] - qx[0]) * (qy[2] - qy[0])
                     - (qy[1] - qy[0]) * (qx[2] - qx[0]))
            d = _signed_dist2(px, py, qx, qy, area2, fd.valid[:, None, sl])
            S = S + nnf.softplus(-d * inv_sigma).sum(-1)
        rows.append(S)
    S = torch.cat(rows, dim=1)
    return (S if _return_sum else 1.0 - torch.exp(-S)).reshape(B, H, W)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def soft_silhouette(
    meshes: Meshes,
    camera: PerspectiveCamera,
    sigma: float = 1e-4,
    tile: int = 16,
    faces_per_tile: int = 256,
    impl: str = "auto",
) -> torch.Tensor:
    """Soft silhouette over all faces (the exact SoftRas formulation),
    (B, H, W).

    impl: "pallas" runs the CUDA kernel pair (cuda_soft.soft_silhouette_fd
    at its defaults, lane layout, every tile active, faces_per_tile rounded
    up to a multiple of 128; on CPU tensors its plain versions); "binned"
    the plain tile-binned route; "auto" the kernels for CUDA tensors and
    the plain route otherwise."""
    if impl == "auto":
        impl = "pallas" if meshes.verts.is_cuda else "binned"
    fp = setup_face_planes(meshes, camera)
    if impl == "pallas":
        from .cuda_soft import soft_silhouette_fd

        fpt = -(-min(faces_per_tile, fp.num_faces) // 128) * 128
        return soft_silhouette_fd(fp, camera.image_size, sigma=sigma,
                                  tile=tile, faces_per_tile=fpt)
    if impl != "binned":
        raise ValueError(f"unknown soft-silhouette impl {impl!r}")
    return soft_silhouette_binned(fp, camera.image_size, sigma=sigma,
                                  tile=tile, faces_per_tile=faces_per_tile)


def soft_silhouette_streaming(
    meshes: Meshes,
    camera: PerspectiveCamera,
    sigma: float = 1e-4,
    pixel_chunk: int = 8192,
    face_chunk: int = 1024,
) -> torch.Tensor:
    """Dense-streaming soft silhouette (oracle; no face-count caps)."""
    fp = setup_face_planes(meshes, camera)
    return soft_silhouette_streaming_face_data(
        fp, camera.image_size, sigma=sigma,
        pixel_chunk=pixel_chunk, face_chunk=face_chunk,
    )

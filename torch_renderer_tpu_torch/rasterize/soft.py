"""Dense streaming soft silhouette: the exact oracle for the tile-binned
kernel path (PyTorch counterpart of ``torch_renderer_tpu.rasterize.soft``'s
streaming functions).

SoftRas coverage alpha(p) = 1 - prod_f (1 - sigmoid(-d_f(p)/sigma)) is, in
log space, a sum: alpha(p) = 1 - exp(-sum_f softplus(-d_f(p)/sigma)), where
d_f is the signed squared distance from pixel p to face f (negative inside).
This module evaluates every (pixel, face) pair in bounded chunks, with no
per-tile face cap. Tests and the chip smoke run use it; the main path does
not.
"""

from __future__ import annotations

import torch
import torch.nn.functional as nnf

from ..cameras.perspective import PerspectiveCamera
from ..structures.meshes import Meshes
from .geometry import FacePlanes, setup_face_planes

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


def _signed_dist2(px, py, qx, qy, area2, valid):
    """Signed squared distance (B, P, Fc) from pixels (1, P, 1) to faces
    (B, 1, Fc); invalid faces get +1e9. The inside test is the barycentric
    one of the JAX streaming oracle: every edge function over area2 >= 0."""
    safe_area = torch.where(area2.abs() > 1e-12, area2, torch.ones_like(area2))
    inside = None
    d2 = None
    for a, b in ((0, 1), (1, 2), (2, 0)):
        gx = qx[b] - qx[a]
        gy = qy[b] - qy[a]
        wx = px - qx[a]
        wy = py - qy[a]
        # edge function of the edge opposite the third corner, over area2
        in_e = (gx * wy - gy * wx) / safe_area >= 0.0
        inside = in_e if inside is None else inside & in_e
        len2 = (gx * gx + gy * gy).clamp_min(1e-12)
        wg = wx * gx + wy * gy
        t = (wg * (1.0 / len2)).clamp(0.0, 1.0)
        dd = wx * wx + wy * wy - 2.0 * t * wg + t * t * len2
        d2 = dd if d2 is None else torch.minimum(d2, dd)
    d2 = d2.clamp_min(0.0)
    signed = torch.where(inside, -d2, d2)
    return torch.where(valid, signed, torch.full_like(signed, 1e9))


def soft_silhouette_streaming_face_data(
    fp: FacePlanes,
    image_size,
    sigma: float = 1e-4,
    pixel_chunk: int = 8192,
    face_chunk: int = 1024,
) -> torch.Tensor:
    """Soft coverage (B, H, W), dense over every face, chunked over pixels
    and faces."""
    H, W = image_size
    device = fp.x0.device
    pix = pixel_coords_raster((H, W), device)
    B, F = fp.x0.shape
    qx_all = (fp.x0, fp.x1, fp.x2)
    qy_all = (fp.y0, fp.y1, fp.y2)
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
            d = _signed_dist2(px, py, qx, qy, area2, fp.valid[:, None, sl])
            S = S + nnf.softplus(-d * inv_sigma).sum(-1)
        rows.append(S)
    S = torch.cat(rows, dim=1)
    return (1.0 - torch.exp(-S)).reshape(B, H, W)


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

"""Plain PyTorch projection of a scene's faces into raster space, shared by
the references and the work counts. It imports nothing of the program.

Conventions (the reference renderer's, pytorch3d's with OpenCV extrinsics):
X_cam = R X + t; u = fx x / z + cx, v = fy y / z + cy in pixels, pixel
centres at integer + 0.5; raster x = (u - W/2) / s, y = (v - H/2) / s with
s = min(H, W) / 2.
"""

from __future__ import annotations

import torch

ZNEAR = 1e-5
EPS_AREA = 1e-12


def project(verts, faces, K, R, t, image_size, dtype=torch.float32):
    """Faces of ``verts`` ((V, 3) shared by every view, or (N, V, 3)) seen
    by N cameras, in ``dtype``. Returns (q (N, F, 3, 2) raster corners,
    z (N, F, 3) camera depths, valid (N, F): every corner in front of
    znear and a doubled raster area above EPS_AREA)."""
    H, W = image_size
    s = min(H, W) / 2.0
    verts, K, R, t = (a.to(dtype) for a in (verts, K, R, t))
    eq = "nij,vj->nvi" if verts.ndim == 2 else "nij,nvj->nvi"
    cam = torch.einsum(eq, R, verts) + t[:, None, :]
    z = cam[..., 2]
    x = ((K[0, 0] * cam[..., 0] / z + K[0, 2]) - W / 2.0) / s
    y = ((K[1, 1] * cam[..., 1] / z + K[1, 2]) - H / 2.0) / s
    xy = torch.stack([x, y], dim=-1)                        # (N, V, 2)
    q = xy[:, faces]                                        # (N, F, 3, 2)
    fz = z[:, faces]                                        # (N, F, 3)
    area2 = cross(q[..., 1, :] - q[..., 0, :], q[..., 2, :] - q[..., 0, :])
    valid = (fz > ZNEAR).all(-1) & (area2.abs() > EPS_AREA)
    return q, fz, valid


def cross(a, b):
    """2D cross product of (..., 2) vectors."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def pixel_centres(image_size, device, dtype=torch.float32):
    """(H * W, 2) raster coordinates of every pixel centre, row-major."""
    H, W = image_size
    s = min(H, W) / 2.0
    ys = (torch.arange(H, device=device, dtype=torch.float64) + 0.5
          - H / 2.0) / s
    xs = (torch.arange(W, device=device, dtype=torch.float64) + 0.5
          - W / 2.0) / s
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], -1).to(dtype)


def box_pixels(lo, hi, image_size, margin: int = 1):
    """Pixel rows and columns whose centres may lie in the raster boxes
    [lo, hi] ((M, 2) each): (col0, row0, ncols, nrows), each (M,) int64,
    the ranges grown by ``margin`` pixels against rounding and clipped to
    the image (empty where the box misses it)."""
    H, W = image_size
    s = min(H, W) / 2.0
    lo, hi = lo.double(), hi.double()
    c0 = torch.ceil(lo[:, 0] * s + W / 2.0 - 0.5).long() - margin
    c1 = torch.floor(hi[:, 0] * s + W / 2.0 - 0.5).long() + margin
    r0 = torch.ceil(lo[:, 1] * s + H / 2.0 - 0.5).long() - margin
    r1 = torch.floor(hi[:, 1] * s + H / 2.0 - 0.5).long() + margin
    c0, r0 = c0.clamp(0, W), r0.clamp(0, H)
    c1, r1 = c1.clamp(-1, W - 1), r1.clamp(-1, H - 1)
    return c0, r0, (c1 - c0 + 1).clamp_min(0), (r1 - r0 + 1).clamp_min(0)


def box_pairs(lo, hi, image_size, block: int, margin: int = 1):
    """Every (box, pixel) pair of the boxes' pixel ranges (box_pixels), in
    blocks of about ``block`` pairs: yields (box index (P,), pixel row (P,),
    pixel column (P,)), all int64 on the boxes' device."""
    c0, r0, nc, nr = box_pixels(lo, hi, image_size, margin)
    n = nc * nr
    if n.numel() == 0:
        return
    ends = torch.cumsum(n, 0)
    starts = ends - n
    total = int(ends[-1])
    first = 0
    while first < total:
        last = min(total, first + block)
        k = torch.arange(first, last, device=lo.device)
        box = torch.searchsorted(ends, k, right=True)
        off = k - starts[box]
        row = r0[box] + off // nc[box]
        col = c0[box] + off % nc[box]
        yield box, row, col
        first = last

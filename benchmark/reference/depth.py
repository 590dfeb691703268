"""Plain PyTorch depth render with one face a pixel (K = 1): the reference
of the depth cells. It imports nothing of the program.

A pixel is covered by a valid face when its centre lies in the face's
raster triangle (every barycentric >= 0); its depth there is the
perspective-correct z = 1 / sum_k(b_k / z_k). The depth image holds the
least such z, and 0 where no face covers the pixel.

A face can cover only the pixels in its raster bounding box, so the
reference visits those (grown by a pixel against rounding) and no others:
the same answer as a visit of every (pixel, face) pair, in about a
thousandth of the work at 720p. The least z per pixel is a
``scatter_reduce`` over the visited pairs, in blocks of faces.
"""

from __future__ import annotations

import torch

from reference.geometry import ZNEAR, box_pairs, cross, project

PAIRS_PER_BLOCK = 1 << 24


def depth(verts, faces, K, R, t, image_size, dtype=torch.float32):
    """(N, H, W) float32 depth images of ``verts`` (V, 3) under N cameras,
    computed in ``dtype``."""
    H, W = image_size
    s = min(H, W) / 2.0
    q, z, valid = project(verts, faces, K, R, t, image_size, dtype)
    N, F = valid.shape
    q, z = q.reshape(N * F, 3, 2)[valid.reshape(-1)], \
        z.reshape(N * F, 3)[valid.reshape(-1)]
    view = torch.arange(N, device=q.device).repeat_interleave(F)[
        valid.reshape(-1)]
    area2 = cross(q[:, 1] - q[:, 0], q[:, 2] - q[:, 0])
    out = torch.full((N * H * W,), float("inf"), dtype=torch.float32,
                     device=q.device)
    for f, row, col in box_pairs(q.amin(1), q.amax(1), image_size,
                                 PAIRS_PER_BLOCK):
        px = ((col.to(torch.float64) + 0.5 - W / 2.0) / s).to(dtype)
        py = ((row.to(torch.float64) + 0.5 - H / 2.0) / s).to(dtype)
        p = torch.stack([px, py], -1)
        qf, zf = q[f], z[f]
        b = [cross(qf[:, (k + 2) % 3] - qf[:, (k + 1) % 3],
                   p - qf[:, (k + 1) % 3]) / area2[f] for k in range(3)]
        inside = (b[0] >= 0) & (b[1] >= 0) & (b[2] >= 0)
        zp = 1.0 / (b[0] / zf[:, 0] + b[1] / zf[:, 1] + b[2] / zf[:, 2])
        hit = inside & (zp > ZNEAR)
        idx = (view[f] * H + row) * W + col
        out.scatter_reduce_(0, idx[hit], zp[hit].float(), "amin")
    out = torch.where(torch.isinf(out), torch.zeros_like(out), out)
    return out.reshape(N, H, W)

"""Plain PyTorch soft silhouette, dense over every face: the reference of
the soft cells. It imports nothing of the program.

Per pixel p and face f: d2 = the least squared distance from p to the
face's three edges (segments); signed d2 = -d2 inside the face, +d2
outside; S(p) = sum over valid faces of softplus(-signed d2 / sigma);
alpha = 1 - exp(-S) (SoftRas, pytorch3d's SoftSilhouetteShader with
sigmoid blending). The gradient is autograd's through the squared
distances, with the inside test and each edge's clamped foot parameter
held fixed, as the reference renderer's hand-derived backward does.

Work is done in blocks of pixels over every view and every face at once,
so that memory stays bounded at any scene size.
"""

from __future__ import annotations

import torch

from reference.geometry import cross, pixel_centres, project

PAIRS_PER_BLOCK = 1 << 22


def signed_d2(px, py, q):
    """Signed squared distance from pixels (px, py) to the boundary of the
    faces q (..., 3, 2) of raster corners, negative inside; px, py and
    q[..., 0, 0] broadcast together."""
    qx = [q[..., k, 0] for k in range(3)]
    qy = [q[..., k, 1] for k in range(3)]
    area2 = cross(q[..., 1, :] - q[..., 0, :], q[..., 2, :] - q[..., 0, :])
    d2, inside = None, None
    for a, b in ((0, 1), (1, 2), (2, 0)):
        gx, gy = qx[b] - qx[a], qy[b] - qy[a]
        wx, wy = px - qx[a], py - qy[a]
        len2 = (gx * gx + gy * gy).clamp_min(1e-12)
        wg = wx * gx + wy * gy
        t = (wg / len2).clamp(0.0, 1.0).detach()
        dd = (wx * wx + wy * wy - 2.0 * t * wg + t * t * len2).clamp_min(0.0)
        d2 = dd if d2 is None else torch.minimum(d2, dd)
        side = ((gx * wy - gy * wx) * area2 >= 0.0).detach()
        inside = side if inside is None else inside & side
    return torch.where(inside, -d2, d2)


def _alpha_block(p, q, valid, sigma):
    """alpha (N, P) of pixels p (P, 2) under faces q (N, F, 3, 2)."""
    x = -signed_d2(p[None, :, None, 0], p[None, :, None, 1],
                   q[:, None]) / sigma
    term = x.clamp_min(0.0) + torch.log1p(torch.exp(-x.abs()))
    S = (term * valid[:, None, :].to(term.dtype)).sum(-1)
    return 1.0 - torch.exp(-S)                                   # (N, P)


def soft_alpha(verts, faces, K, R, t, image_size, sigma, grad=False,
               dtype=torch.float32):
    """alpha (N, H, W) of ``verts`` ((V, 3) or (N, V, 3)) under N cameras,
    computed in ``dtype`` and returned in float32; with grad, also
    d sum(alpha) / d verts, shaped as verts."""
    H, W = image_size
    v = verts.detach().to(dtype).requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        q, _, valid = project(v, faces, K, R, t, image_size, dtype)
    N, F = valid.shape
    leaf = q.detach().requires_grad_(grad)
    pix = pixel_centres(image_size, verts.device, dtype)
    step = max(1, PAIRS_PER_BLOCK // (N * F))
    alpha = torch.empty((N, H * W), dtype=torch.float32, device=verts.device)
    dq = torch.zeros_like(leaf) if grad else None
    for p0 in range(0, H * W, step):
        p = pix[p0:p0 + step]
        if grad:
            with torch.enable_grad():
                a = _alpha_block(p, leaf, valid, sigma)
                (g,) = torch.autograd.grad(a.sum(), leaf)
            dq += g
        else:
            with torch.no_grad():
                a = _alpha_block(p, leaf, valid, sigma)
        alpha[:, p0:p0 + step] = a.detach().float()
    alpha = alpha.reshape(N, H, W)
    if not grad:
        return alpha
    (gv,) = torch.autograd.grad(q, v, dq)
    return alpha, gv.float()

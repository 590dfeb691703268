"""Quaternion and rotation-matrix conversions (PyTorch counterpart of the
pose-fit subset of ``torch_renderer_tpu.transforms.so3``).

Conventions, as in the JAX package:
  * quaternions are (w, x, y, z), not normalized unless stated;
  * rotation matrices act on column vectors: x' = R @ x.

Every function broadcasts over leading batch dims and is differentiable
(no data-dependent control flow).
"""

from __future__ import annotations

import torch


def quaternion_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternion(s) to unit norm. (..., 4) -> (..., 4)."""
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(eps)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) quaternion(s) (..., 4) -> rotation matrices (..., 3, 3).

    q need not be normalized: the products are scaled by 2/|q|^2."""
    w, x, y, z = q.unbind(-1)
    s = 2.0 / (q * q).sum(-1).clamp_min(1e-12)
    rows = [
        torch.stack([1 - s * (y * y + z * z), s * (x * y - z * w),
                     s * (x * z + y * w)], -1),
        torch.stack([s * (x * y + z * w), 1 - s * (x * x + z * z),
                     s * (y * z - x * w)], -1),
        torch.stack([s * (x * z - y * w), s * (y * z + x * w),
                     1 - s * (x * x + y * y)], -1),
    ]
    return torch.stack(rows, dim=-2)


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> unit quaternions (..., 4), w >= 0.

    Branch-free Shepperd method: all four candidates are computed and the
    one anchored on the largest diagonal combination is kept."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    q_abs2 = torch.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], dim=-1)
    q_abs = torch.sqrt(q_abs2.clamp_min(0.0))

    # candidate quaternions, one row per anchor component (w, x, y, z)
    cand = torch.stack([
        torch.stack([q_abs2[..., 0], m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, q_abs2[..., 1], m10 + m01, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, q_abs2[..., 2], m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs2[..., 3]], -1),
    ], dim=-2)
    cand = cand / (2.0 * q_abs.clamp_min(1e-8))[..., None]

    best = q_abs2.argmax(dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.take_along_dim(cand, idx, dim=-2)[..., 0, :]
    # canonical sign (w >= 0), then normalize
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return quaternion_normalize(q)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions (..., 4) x (..., 4) -> (..., 4)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)

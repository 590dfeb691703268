"""SO(3) / SE(3) rotation representations (PyTorch counterpart of
``torch_renderer_tpu.transforms.so3``): quaternions, axis-angle and Euler
angles, rigid transforms and their homogeneous form.

Conventions, as in the JAX package:
  * quaternions are (w, x, y, z), not normalized unless stated;
  * rotation matrices act on column vectors: x' = R @ x;
  * Euler angles are intrinsic rotations in the order of ``convention``.

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


def quaternion_apply(q: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Rotate point(s) (..., 3) by quaternion(s) (..., 4), normalized
    first: x' = x + w t + v x t with t = 2 v x x."""
    qn = quaternion_normalize(q)
    w, v = qn[..., :1], qn[..., 1:]
    t = 2.0 * torch.linalg.cross(v, point, dim=-1)
    return point + w * t + torch.linalg.cross(v, t, dim=-1)


def quaternion_invert(q: torch.Tensor) -> torch.Tensor:
    """Inverse (the conjugate, for a unit quaternion)."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quaternion_distance(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Angle (radians) between two rotations given as quaternions:
    2 acos(|<q1, q2>|) of the normalized pair, the dot clipped to
    [-1 + 1e-7, 1 - 1e-7] so the gradient stays finite."""
    q1 = quaternion_normalize(q1)
    q2 = quaternion_normalize(q2)
    dot = (q1 * q2).sum(-1).abs()
    return 2.0 * torch.arccos(dot.clamp(-1.0 + 1e-7, 1.0 - 1e-7))


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle vector(s) (..., 3) -> rotation matrices
    (..., 3, 3). sin(t)/t and (1 - cos(t))/t^2 switch to their series
    below t^2 = 1e-12, with t^2 made safe first so the unused branch's
    gradient stays finite at t = 0."""
    theta2 = (axis_angle * axis_angle).sum(-1)
    small = theta2 < 1e-12
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    sinc = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    cosc = torch.where(small, 0.5 - theta2 / 24.0,
                       (1.0 - torch.cos(theta)) / theta2_safe)
    x, y, z = axis_angle.unbind(-1)
    zero = torch.zeros_like(x)
    K = torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], dim=-2)
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device)
    return eye + sinc[..., None, None] * K + cosc[..., None, None] * (K @ K)


def matrix_to_axis_angle(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle vectors (..., 3), by the
    quaternion's log map."""
    q = matrix_to_quaternion(m)
    w = q[..., 0].clamp(-1.0, 1.0)
    v = q[..., 1:]
    vn = torch.linalg.norm(v, dim=-1)
    angle = 2.0 * torch.atan2(vn, w)
    return v / vn.clamp_min(1e-12)[..., None] * angle[..., None]


def _axis_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        flat = (one, zero, zero, zero, c, -s, zero, s, c)
    elif axis == "Y":
        flat = (c, zero, s, zero, one, zero, -s, zero, c)
    elif axis == "Z":
        flat = (c, -s, zero, s, c, zero, zero, zero, one)
    else:
        raise ValueError(f"invalid axis {axis!r}")
    return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))


def euler_angles_to_matrix(euler_angles: torch.Tensor,
                           convention: str = "XYZ") -> torch.Tensor:
    """Euler angles (..., 3) -> rotation matrices, intrinsic rotations
    (pytorch3d's semantics): R = R(c[0], a0) @ R(c[1], a1) @ R(c[2], a2)
    for any three-letter convention over X, Y, Z."""
    if len(convention) != 3 or any(a not in "XYZ" for a in convention):
        raise ValueError(f"invalid convention {convention!r}")
    ms = [_axis_rotation(a, euler_angles[..., i])
          for i, a in enumerate(convention)]
    return ms[0] @ ms[1] @ ms[2]


def matrix_to_euler_angles(m: torch.Tensor,
                           convention: str = "XYZ") -> torch.Tensor:
    """Rotation matrices -> XYZ euler angles (..., 3); the JAX package
    extracts the XYZ convention only, and so does this."""
    if convention != "XYZ":
        raise NotImplementedError("only XYZ extraction is provided")
    y = torch.arcsin(m[..., 0, 2].clamp(-1.0, 1.0))
    x = torch.atan2(-m[..., 1, 2], m[..., 2, 2])
    z = torch.atan2(-m[..., 0, 1], m[..., 0, 0])
    return torch.stack([x, y, z], dim=-1)


def random_rotations(generator: torch.Generator, n: int,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """(n, 3, 3) uniformly random rotations, from normalized Gaussian
    quaternions drawn from ``generator`` (on its device unless given)."""
    q = torch.randn((n, 4), dtype=dtype, device=generator.device,
                    generator=generator)
    if device is not None:
        q = q.to(device)
    return quaternion_to_matrix(quaternion_normalize(q))


def se3_compose(R1, t1, R2, t2):
    """(R1, t1) after (R2, t2): x -> R1 (R2 x + t2) + t1."""
    return R1 @ R2, (R1 @ t2[..., None])[..., 0] + t1


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def transform_points(R: torch.Tensor, t: torch.Tensor,
                     points: torch.Tensor) -> torch.Tensor:
    """x' = R x + t for points (..., P, 3), R (..., 3, 3), t (..., 3)."""
    return torch.einsum("...ij,...pj->...pi", R, points) + t[..., None, :]


def matrix4x4_from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) and (..., 3) -> homogeneous (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    m = R.new_zeros(batch + (4, 4))
    m[..., :3, :3] = R
    m[..., :3, 3] = t
    m[..., 3, 3] = 1.0
    return m


def rt_from_matrix4x4(m: torch.Tensor):
    """Homogeneous (..., 4, 4) -> (R (..., 3, 3), t (..., 3))."""
    return m[..., :3, :3], m[..., :3, 3]

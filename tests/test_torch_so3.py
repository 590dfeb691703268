"""The port's SO(3) / SE(3) helpers (transforms/so3.py) against the JAX
package's on the CPU, and tests/test_transforms.py's scipy cases on the
port. Inputs are made from a seed with numpy and given to both packages.

Tolerances: 1e-6 against JAX (the same float32 formulas; matrix products
and trigonometric functions round differently by a few ulp); 1e-5 against
scipy (float64), as tests/test_transforms.py holds the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from torch_renderer_tpu.transforms import so3 as jso3
from torch_renderer_tpu_torch.transforms import so3

TOL = 1e-6
CONVENTIONS = ["XYZ", "ZYX", "XZY", "YXZ", "ZXZ", "XYX"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _close(ours, theirs, tol=TOL):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs),
                               atol=tol, rtol=0)


def _t(x):
    return torch.tensor(np.asarray(x))


def test_quaternion_apply_matches_jax():
    rng = _rng(1)
    q = rng.normal(size=(16, 4)).astype(np.float32)   # not normalized
    p = rng.normal(size=(16, 3)).astype(np.float32)
    _close(so3.quaternion_apply(_t(q), _t(p)),
           jso3.quaternion_apply(jnp.asarray(q), jnp.asarray(p)))
    # broadcast: one quaternion over many points
    _close(so3.quaternion_apply(_t(q[:1]), _t(p)),
           jso3.quaternion_apply(jnp.asarray(q[:1]), jnp.asarray(p)))


def test_quaternion_invert_and_distance_match_jax():
    rng = _rng(2)
    q1, q2 = _quats(rng, 32), _quats(rng, 32)
    _close(so3.quaternion_invert(_t(q1)), jso3.quaternion_invert(q1))
    _close(so3.quaternion_distance(_t(q1), _t(q2)),
           jso3.quaternion_distance(jnp.asarray(q1), jnp.asarray(q2)))
    # a quaternion and its negation are one rotation
    _close(so3.quaternion_distance(_t(q1), _t(-q1)), np.zeros(32), 1e-3)


@pytest.mark.parametrize("scale", [1e-7, 1e-3, 1.0, 3.0])
def test_axis_angle_to_matrix_matches_jax(scale):
    """Small angles take the series branch (theta^2 < 1e-12)."""
    aa = (_rng(3).normal(size=(16, 3)) * scale).astype(np.float32)
    _close(so3.axis_angle_to_matrix(_t(aa)),
           jso3.axis_angle_to_matrix(jnp.asarray(aa)))


def test_axis_angle_zero_is_exact_and_grad_safe():
    z = torch.zeros(3, requires_grad=True)
    m = so3.axis_angle_to_matrix(z)
    assert torch.equal(m, torch.eye(3))
    m.sum().backward()
    assert torch.isfinite(z.grad).all()


def test_matrix_to_axis_angle_matches_jax():
    R = Rotation.random(32, random_state=4).as_matrix().astype(np.float32)
    _close(so3.matrix_to_axis_angle(_t(R)),
           jso3.matrix_to_axis_angle(jnp.asarray(R)))


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_euler_angles_to_matrix_matches_jax(convention):
    ang = _rng(5).uniform(-np.pi, np.pi, size=(16, 3)).astype(np.float32)
    _close(so3.euler_angles_to_matrix(_t(ang), convention),
           jso3.euler_angles_to_matrix(jnp.asarray(ang), convention))


def test_euler_rejects_bad_conventions():
    with pytest.raises(ValueError):
        so3.euler_angles_to_matrix(torch.zeros(3), "XYW")
    with pytest.raises(NotImplementedError):
        so3.matrix_to_euler_angles(torch.eye(3), "ZYX")


def test_matrix_to_euler_angles_matches_jax():
    ang = _rng(6).uniform(-1.2, 1.2, size=(16, 3)).astype(np.float32)
    R = np.asarray(jso3.euler_angles_to_matrix(jnp.asarray(ang), "XYZ"))
    ours = so3.matrix_to_euler_angles(_t(R), "XYZ")
    _close(ours, jso3.matrix_to_euler_angles(jnp.asarray(R), "XYZ"))
    _close(ours, ang, 1e-5)


def test_random_rotations_are_rotations():
    R = so3.random_rotations(torch.Generator().manual_seed(0), 64)
    assert R.shape == (64, 3, 3)
    _close(R @ R.transpose(1, 2), np.broadcast_to(np.eye(3), (64, 3, 3)),
           1e-5)
    _close(torch.linalg.det(R), np.ones(64), 1e-5)


def test_se3_helpers_match_jax():
    rng = _rng(7)
    R1 = Rotation.random(4, random_state=8).as_matrix().astype(np.float32)
    R2 = Rotation.random(4, random_state=9).as_matrix().astype(np.float32)
    t1 = rng.normal(size=(4, 3)).astype(np.float32)
    t2 = rng.normal(size=(4, 3)).astype(np.float32)
    for ours, theirs in zip(so3.se3_compose(_t(R1), _t(t1), _t(R2), _t(t2)),
                            jso3.se3_compose(R1, t1, R2, t2)):
        _close(ours, theirs)
    for ours, theirs in zip(so3.se3_inverse(_t(R1), _t(t1)),
                            jso3.se3_inverse(R1, t1)):
        _close(ours, theirs)
    m = so3.matrix4x4_from_rt(_t(R1), _t(t1))
    _close(m, jso3.matrix4x4_from_rt(jnp.asarray(R1), jnp.asarray(t1)), 0)
    R, t = so3.rt_from_matrix4x4(m)
    assert torch.equal(R, _t(R1)) and torch.equal(t, _t(t1))
    # one rotation broadcast against a batch of translations
    _close(so3.matrix4x4_from_rt(_t(R1[0]), _t(t2)),
           jso3.matrix4x4_from_rt(jnp.asarray(R1[0]), jnp.asarray(t2)), 0)


def test_transform_points_matches_jax():
    rng = _rng(10)
    R = Rotation.random(3, random_state=11).as_matrix().astype(np.float32)
    t = rng.normal(size=(3, 3)).astype(np.float32)
    p = rng.normal(size=(3, 10, 3)).astype(np.float32)
    _close(so3.transform_points(_t(R), _t(t), _t(p)),
           jso3.transform_points(R, t, p))


# tests/test_transforms.py's scipy cases, on the port ------------------------

def test_quaternion_to_matrix_matches_scipy():
    q = _quats(_rng(12), 32)
    theirs = Rotation.from_quat(q[:, [1, 2, 3, 0]]).as_matrix()
    _close(so3.quaternion_to_matrix(_t(q)), theirs, 1e-5)


def test_matrix_quaternion_roundtrip():
    q = _quats(_rng(13), 64)
    q[q[:, 0] < 0] *= -1
    m = so3.quaternion_to_matrix(_t(q))
    _close(so3.matrix_to_quaternion(m), q, 1e-5)


def test_matrix_to_quaternion_near_identity_and_pi():
    for R in [np.eye(3), Rotation.from_rotvec([np.pi, 0, 0]).as_matrix(),
              Rotation.from_rotvec([0, np.pi - 1e-4, 0]).as_matrix()]:
        R = torch.tensor(R, dtype=torch.float32)
        q = so3.matrix_to_quaternion(R)
        _close(so3.quaternion_to_matrix(q), R, 1e-5)


def test_axis_angle_matches_scipy():
    aa = _rng(14).normal(size=(16, 3)).astype(np.float32)
    _close(so3.axis_angle_to_matrix(_t(aa)),
           Rotation.from_rotvec(aa).as_matrix(), 1e-5)


def test_euler_angles_matches_scipy():
    ang = _rng(15).uniform(-np.pi, np.pi, size=(16, 3)).astype(np.float32)
    _close(so3.euler_angles_to_matrix(_t(ang), "XYZ"),
           Rotation.from_euler("XYZ", ang).as_matrix(), 1e-5)


def test_quaternion_apply_consistent_with_matrix():
    rng = _rng(16)
    q, p = _t(_quats(rng, 8)), _t(rng.normal(size=(8, 3)).astype(np.float32))
    via_mat = torch.einsum("bij,bj->bi", so3.quaternion_to_matrix(q), p)
    _close(so3.quaternion_apply(q, p), via_mat, 1e-5)


def test_quaternion_distance_angle():
    q2 = torch.tensor(Rotation.from_rotvec([0.3, 0, 0]).as_quat()[[3, 0, 1, 2]],
                      dtype=torch.float32)[None]
    d = float(so3.quaternion_distance(torch.tensor([[1.0, 0, 0, 0]]), q2)[0])
    assert abs(d - 0.3) < 1e-3


def test_se3_inverse_composes_to_identity():
    rng = _rng(17)
    R = _t(Rotation.random(4, random_state=18).as_matrix().astype(np.float32))
    t = _t(rng.normal(size=(4, 3)).astype(np.float32))
    Rc, tc = so3.se3_compose(R, t, *so3.se3_inverse(R, t))
    _close(Rc, np.broadcast_to(np.eye(3), (4, 3, 3)), 1e-5)
    _close(tc, np.zeros((4, 3)), 1e-5)


def test_transform_points_matches_loop():
    rng = _rng(19)
    R = Rotation.random(3, random_state=20).as_matrix().astype(np.float32)
    t = rng.normal(size=(3, 3)).astype(np.float32)
    p = rng.normal(size=(3, 10, 3)).astype(np.float32)
    ref = np.stack([p[b] @ R[b].T + t[b] for b in range(3)])
    _close(so3.transform_points(_t(R), _t(t), _t(p)), ref, 1e-5)

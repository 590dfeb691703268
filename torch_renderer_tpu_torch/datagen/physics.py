"""Rigid-body pose settling, the reference's Blender physics step, on the
device (PyTorch counterpart of ``torch_renderer_tpu.datagen.physics``).

The reference drops its scene objects with BlenderProc physics and adopts
the settled poses (coco_data_generator.py:296-309). Here every object is a
static set of P collision-proxy points in body frame plus a bounding
radius, and a semi-implicit Euler integrator applies gravity, ground-plane
contact (a spring-damper normal force at each penetrating proxy with
Coulomb-style friction, so unstable orientations topple), soft room walls
and pairwise sphere separation, with quaternion orientations integrated as
q += dt/2 (0, w) x q and renormalized. The arithmetic is the JAX package's,
operation for operation.

The JAX package runs the whole settle as one jitted ``lax.scan``. Here a
``Settler`` holds the body state in static device buffers and runs the
steps as replays of one ``utils.graph.StepGraph`` (``capture=None``:
captured on a CUDA device, eager on the CPU), gcd(sim_steps,
STEPS_PER_REPLAY) integration steps a replay; one Settler captures once and
settles any number of scenes of its body count. Inertia is the solid
sphere's, I = (2/5) m r^2.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..transforms.so3 import (
    quaternion_apply,
    quaternion_multiply,
    quaternion_normalize,
    quaternion_to_matrix,
)
from ..utils.graph import StepGraph

# Integration steps in one StepGraph call, when they divide sim_steps (the
# default 1500 runs as 30 replays); else their greatest common divisor.
STEPS_PER_REPLAY = 50


@dataclasses.dataclass(frozen=True)
class SettleConfig:
    """Integrator parameters. The defaults settle the datagen primitive
    library (~0.1 m objects) from a ~2-radius drop in sim_steps * dt = 3 s
    of simulated time, the reference's minimum physics window."""

    dt: float = 2e-3
    sim_steps: int = 1500
    gravity: float = -9.81
    mass: float = 1.0
    k_contact: float = 4000.0       # ground spring stiffness (per proxy)
    c_contact: float = 40.0         # ground normal damping (per proxy)
    friction: float = 0.6           # Coulomb friction coefficient
    k_pair: float = 4000.0          # sphere-sphere separation stiffness
    c_pair: float = 10.0            # pair normal damping
    lin_damping: float = 0.02       # per-step velocity decay (numeric)
    ang_damping: float = 0.05
    rolling_resistance: float = 0.3  # w-decay torque while touching ground
    z_plane: float = 0.0
    # soft boundary walls: beyond +-extent in x/y a spring pushes the COM
    # back in; 0 disables.
    extent: float = 0.0
    k_wall: float = 2000.0


def collision_proxies(
    verts: np.ndarray, n_points: int = 32, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Static collision proxies for one object (host side, once per library
    entry): (P, 3) body-frame points, (3,) center of mass, bounding radius.
    Farthest-point subsampling keeps the extreme vertices, the ones that
    touch the ground first."""
    v = np.asarray(verts, np.float32)
    com = v.mean(axis=0)
    rel = v - com
    n_pick = min(n_points, rel.shape[0])
    rng = np.random.default_rng(seed)
    picked = [int(rng.integers(rel.shape[0]))]
    d = np.linalg.norm(rel - rel[picked[0]], axis=1)
    for _ in range(n_pick - 1):
        nxt = int(np.argmax(d))
        picked.append(nxt)
        d = np.minimum(d, np.linalg.norm(rel - rel[nxt], axis=1))
    pts = rel[np.asarray(picked)]
    if pts.shape[0] < n_points:  # tiny meshes: pad by repeating
        reps = -(-n_points // pts.shape[0])
        pts = np.tile(pts, (reps, 1))[:n_points]
    radius = float(np.linalg.norm(rel, axis=1).max())
    return pts, com, radius


def _step(cfg: SettleConfig, p, q, v, w, pts, radii, active, eye, gravity):
    """One semi-implicit Euler step over all N bodies: p, v (N, 3), q (N, 4)
    wxyz, w (N, 3) world-frame angular velocity; pts (N, P, 3) body-frame
    proxies, radii (N,), active (N,) 0/1 (padding bodies stay frozen), eye
    the (N, N) identity, gravity the (3,) force of gravity."""
    r = quaternion_apply(q[:, None, :], pts)          # (N, P, 3) lever arms
    x = p[:, None, :] + r                             # world positions
    vel = v[:, None, :] + torch.linalg.cross(w[:, None, :].expand_as(r), r)

    # ground contact: spring-damper normal + Coulomb-style friction
    pen = torch.clamp_min(cfg.z_plane - x[..., 2], 0.0)        # (N, P)
    touching = pen > 0.0
    fn = torch.where(touching, cfg.k_contact * pen - cfg.c_contact * vel[..., 2],
                     torch.zeros_like(pen))
    fn = torch.clamp_min(fn, 0.0)                     # the ground only pushes
    vt = vel[..., :2]
    vt_norm = torch.linalg.norm(vt, dim=-1, keepdim=True)
    # Coulomb cap with a viscous core below v_eps (no jitter at rest)
    v_eps = 1e-2
    ft_mag = cfg.friction * fn
    ft = -vt * (ft_mag / torch.clamp_min(vt_norm[..., 0], v_eps))[..., None]
    f_pts = torch.cat([ft, fn[..., None]], dim=-1)    # (N, P, 3)

    force = f_pts.sum(1)                              # (N, 3)
    torque = torch.linalg.cross(r, f_pts).sum(1)

    # rolling resistance while in ground contact
    grounded = touching.any(1).to(torch.float32)      # (N,)
    torque = torque - (cfg.rolling_resistance * grounded)[:, None] * w

    if cfg.extent > 0.0:  # soft room walls
        over = torch.sign(p[..., :2]) * torch.clamp_min(
            p[..., :2].abs() - cfg.extent, 0.0)
        force = torch.cat([force[..., :2] + (-cfg.k_wall * over),
                           force[..., 2:]], dim=-1)

    # pairwise sphere separation (object-object non-interpenetration)
    dp = p[:, None, :] - p[None, :, :]                # (N, N, 3)
    dist = torch.clamp_min(torch.linalg.norm(dp + eye[..., None], dim=-1),
                           1e-6)                      # self -> ~sqrt(3)
    overlap = torch.clamp_min(radii[:, None] + radii[None, :] - dist, 0.0)
    overlap = overlap * (1.0 - eye)
    pair_mask = active[:, None] * active[None, :]
    n_hat = dp / dist[..., None]
    dv = v[:, None, :] - v[None, :, :]
    vn = (dv * n_hat).sum(-1)
    f_pair_mag = (cfg.k_pair * overlap - cfg.c_pair * vn) \
        * (overlap > 0.0).to(torch.float32)
    f_pair_mag = torch.clamp_min(f_pair_mag, 0.0) * pair_mask
    force = force + (f_pair_mag[..., None] * n_hat).sum(1)

    # gravity + integration (semi-implicit: velocity first)
    force = force + gravity
    inertia = 0.4 * cfg.mass * torch.clamp_min(radii, 1e-4) ** 2    # (N,)
    v_new = (v + (cfg.dt / cfg.mass) * force) * (1.0 - cfg.lin_damping)
    w_new = (w + (cfg.dt / inertia[:, None]) * torque) * (1.0 - cfg.ang_damping)
    p_new = p + cfg.dt * v_new
    dq = 0.5 * cfg.dt * quaternion_multiply(
        torch.cat([torch.zeros_like(w_new[:, :1]), w_new], dim=-1), q)
    q_new = quaternion_normalize(q + dq)

    m = active[:, None] != 0
    return (torch.where(m, p_new, p), torch.where(m, q_new, q),
            torch.where(m, v_new, v), torch.where(m, w_new, w))


class Settler:
    """The settle sim over ``n_bodies`` bodies of ``n_points`` proxies each,
    in static buffers on ``device`` (default: the card), stepped by one
    StepGraph of ``unroll`` = gcd(sim_steps, STEPS_PER_REPLAY) integration
    steps (capture=None: captured on a CUDA device, eager on the CPU;
    False: eager). ``settle`` copies a scene's inputs in and runs sim_steps
    steps: no host read between its first and last step."""

    def __init__(self, n_bodies: int, n_points: int,
                 cfg: SettleConfig = SettleConfig(), device=None,
                 capture=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        dev = self.device
        self.unroll = math.gcd(cfg.sim_steps, STEPS_PER_REPLAY)
        z3 = torch.zeros((n_bodies, 3), dtype=torch.float32, device=dev)
        self.p, self.v, self.w = z3, z3.clone(), z3.clone()
        self.q = torch.zeros((n_bodies, 4), dtype=torch.float32, device=dev)
        self.pts = torch.zeros((n_bodies, n_points, 3), dtype=torch.float32,
                               device=dev)
        self.radii = torch.zeros(n_bodies, dtype=torch.float32, device=dev)
        self.active = torch.zeros(n_bodies, dtype=torch.float32, device=dev)
        self.eye = torch.eye(n_bodies, dtype=torch.float32, device=dev)
        self.gravity = torch.tensor([0.0, 0.0, cfg.gravity * cfg.mass],
                                    dtype=torch.float32, device=dev)
        self.graph = StepGraph(self._steps, dev, capture)

    def _steps(self) -> None:
        state = (self.p, self.q, self.v, self.w)
        for _ in range(self.unroll):
            state = _step(self.cfg, *state, self.pts, self.radii, self.active,
                          self.eye, self.gravity)
        for buf, new in zip((self.p, self.q, self.v, self.w), state):
            buf.copy_(new)

    def settle(self, pts, radii, p0, q0, active):
        """(R (N, 3, 3), t (N, 3), residual_speed) on the device: the
        settled rotations and COM positions, and max over active bodies of
        |v| + r |w| at the end (a convergence diagnostic, ~0 when
        settled)."""
        for buf, x in ((self.pts, pts), (self.radii, radii), (self.p, p0),
                       (self.q, q0), (self.active, active)):
            buf.copy_(torch.as_tensor(x))
        self.v.zero_()
        self.w.zero_()
        for _ in range(self.cfg.sim_steps // self.unroll):
            self.graph()
        speed = (torch.linalg.norm(self.v, dim=-1)
                 + self.radii * torch.linalg.norm(self.w, dim=-1))
        residual = (speed * self.active).max()
        return quaternion_to_matrix(self.q), self.p.clone(), residual


def settle_poses(pts, radii, p0, q0, active,
                 cfg: SettleConfig = SettleConfig(), device=None,
                 capture=None):
    """Run the settle sim once (a Settler of this body count, on ``device``:
    by default the device of ``pts`` when it is a tensor, else the card):
    pts (N, P, 3) body-frame proxies about the COM, radii (N,), p0 (N, 3)
    initial COM positions, q0 (N, 4) wxyz, active (N,) 1 for real bodies
    and 0 for padding. Returns (R (N, 3, 3), t (N, 3), residual_speed)."""
    device = resolve_device(device, like=pts)
    n, P = np.shape(pts)[:2]
    return Settler(n, P, cfg, device, capture).settle(pts, radii, p0, q0,
                                                     active)


def drop_poses(
    rng: np.random.Generator, n: int, xy: np.ndarray, radii: np.ndarray,
    z_plane: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Initial drop states: random orientation, COM 1.5 radii above the
    plane at the sampled xy (the reference samples poses in a volume and
    lets physics bring them down)."""
    p0 = np.concatenate(
        [
            np.asarray(xy, np.float32),
            (z_plane + 1.5 * np.asarray(radii, np.float32))[:, None],
        ],
        axis=1,
    )
    u = rng.normal(size=(n, 4)).astype(np.float32)
    q0 = u / np.linalg.norm(u, axis=1, keepdims=True)
    return p0, q0

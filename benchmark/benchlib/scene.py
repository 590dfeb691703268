"""The benchmark's scenes, made from a configuration file and ``--seed``.

Frozen copies, so that the yardstick does not move with the port:

- ``icosphere``: ``torch_renderer_tpu_torch/ops/icosphere.py:13-59``;
- ``look_at``: ``torch_renderer_tpu_torch/cameras/look_at.py:23-93``
  (pytorch3d's spherical angles, OpenCV extrinsics);
- ``pinhole_K``: ``torch_renderer_tpu_torch/apps/_common.py:60-66``.

The seed varies the data and never a shape: each vertex is moved along its
radius by up to ``displacement`` of the radius (drawn first, so every cell
of a configuration gets the same mesh for a seed), then the views'
rotations (and for look-at scenes a phase of the azimuths) are drawn. The
draws come from a ``torch.Generator`` on the device the scene is made on.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def icosphere(level: int):
    """Subdivided icosahedron on the unit sphere: (verts (V, 3) float32,
    faces (F, 3) int64) as numpy arrays; level 3 has 642 vertices and
    1280 faces."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                      [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                      [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                     dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10],
                      [0, 10, 11], [1, 5, 9], [5, 11, 4], [11, 10, 2],
                      [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6],
                      [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11],
                      [6, 2, 10], [8, 6, 7], [9, 8, 1]], dtype=np.int64)
    for _ in range(level):
        mid: dict = {}
        vl = list(verts)

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = vl[a] + vl[b]
                mid[key] = len(vl)
                vl.append(m / np.linalg.norm(m))
            return mid[key]

        new = []
        for a, b, c in faces.tolist():
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts, faces = np.asarray(vl), np.asarray(new, dtype=np.int64)
    return verts.astype(np.float32), faces


def pinhole_K(image_size, focal_scale: float) -> torch.Tensor:
    """(3, 3) pinhole matrix: focal focal_scale * min(H, W), principal point
    at the image centre."""
    H, W = image_size
    f = focal_scale * min(H, W)
    return torch.tensor([[f, 0.0, W / 2.0], [0.0, f, H / 2.0],
                         [0.0, 0.0, 1.0]], dtype=torch.float32)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(1e-9)


def look_at(dist: float, elev_deg: float, azim_deg: torch.Tensor):
    """OpenCV (R (N, 3, 3), t (N, 3)) of cameras on a sphere around the
    origin looking at it, +Y up: eye = dist * (cos e sin a, sin e,
    cos e cos a); the rows of R are the camera's x, y, z axes."""
    e = math.radians(elev_deg)
    a = torch.deg2rad(azim_deg)
    eye = torch.stack([dist * math.cos(e) * torch.sin(a),
                       torch.full_like(a, dist * math.sin(e)),
                       dist * math.cos(e) * torch.cos(a)], dim=-1)
    z = _normalize(-eye)
    up = torch.tensor([0.0, 1.0, 0.0], device=eye.device).expand(eye.shape)
    x = _normalize(torch.linalg.cross(z, up))
    y = torch.linalg.cross(z, x)
    R = torch.stack([x, y, z], dim=-2)
    return R, -torch.einsum("nij,nj->ni", R, eye)


def random_rotations(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """n rotation matrices (n, 3, 3), uniform over SO(3): unit quaternions
    from normal draws."""
    q = _normalize(torch.randn((n, 4), generator=gen, device=device))
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(n, 3, 3)


def make_scene(config: dict, seed: int, views: int, device) -> dict:
    """The scene of one run: the seeded mesh and ``views`` cameras.

    Returns verts (V, 3), faces (F, 3) int64, K (3, 3), R (views, 3, 3),
    t (views, 3), image_size (H, W) and the configuration. "orbit" scenes
    (config "cameras") place the views on look-at azimuths evenly spaced
    from a seeded phase, each composed with one seeded rotation of the
    object; "turntable" scenes keep the camera at (0, 0, distance) and give
    every view its own seeded rotation of the object."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    if config.get("mesh", "icosphere") != "icosphere":
        raise ValueError(f"unknown mesh {config['mesh']!r}")
    v_np, f_np = icosphere(config["level"])
    verts = torch.as_tensor(v_np, device=device)
    u = torch.rand((verts.shape[0], 1), generator=gen, device=device)
    verts = verts * (1.0 + config["displacement"] * (2.0 * u - 1.0))
    H, W = config["image"]
    K = pinhole_K((H, W), config["focal_scale"]).to(device)
    if config["cameras"] == "orbit":
        # as the depth app: centred and scaled into the unit sphere
        verts = verts - verts.mean(0)
        verts = verts / torch.linalg.norm(verts, dim=-1).amax()
        phase = torch.rand((), generator=gen, device=device) * 360.0
        azim = (torch.arange(views, device=device, dtype=torch.float32)
                * (360.0 / views) + phase) % 360.0
        R_la, t = look_at(config["distance"], config["elevation"], azim)
        R = R_la @ random_rotations(1, gen, device)
    elif config["cameras"] == "turntable":
        R = random_rotations(views, gen, device)
        t = torch.tensor([0.0, 0.0, config["distance"]],
                         device=device).expand(views, 3).contiguous()
    else:
        raise ValueError(f"unknown cameras {config['cameras']!r}")
    return {"verts": verts.contiguous(),
            "faces": torch.as_tensor(f_np, device=device),
            "K": K, "R": R.contiguous(), "t": t.contiguous(),
            "image_size": (H, W), "config": config}

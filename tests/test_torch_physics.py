"""The port's rigid-body settle (datagen/physics.py) against the JAX
package's, on the same seeded numpy drops.

At a shortened SettleConfig (100 steps) the settled rotations, positions
and residual speed must equal JAX's within 1e-5 (the same float32
arithmetic). Over the full 1500 steps contacts make the trajectory chaotic
(at 400 steps the two already differ by ~1e-4), so there the port is held
to tests/test_physics.py's gates: the sphere rests on the floor, a tall
box topples onto a long side, two bodies separate inside the walls, and a
padding body stays frozen. A Settler reused across scenes gives the fresh
run's numbers, and its replays of several steps those of one step at a
time, bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_renderer_tpu.datagen import physics as jphys
from torch_renderer_tpu.ops.icosphere import cube, icosphere
from torch_renderer_tpu_torch.datagen import physics as phys
from torch_renderer_tpu_torch.datagen.coco import (
    COCODataGenerator,
    DataGenConfig,
    ObjectLibrary,
)
from torch_renderer_tpu_torch.transforms.so3 import quaternion_to_matrix

SCALE = 0.12


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bodies(seed=0, n=4, n_active=3):
    sv, _ = icosphere(2)
    cv, _ = cube(1.4)
    shapes = [sv * SCALE, cv * SCALE,
              sv * SCALE * np.array([1.0, 0.6, 0.4], np.float32)]
    prox = [phys.collision_proxies(s) for s in shapes]
    pts = np.stack([prox[i % 3][0] for i in range(n)])
    radii = np.array([prox[i % 3][2] for i in range(n)], np.float32)
    xy = np.array([[0, 0], [0.05, 0.01], [-0.2, 0.1], [0.1, -0.2]],
                  np.float32)[:n]
    p0, q0 = phys.drop_poses(np.random.default_rng(seed), n, xy, radii)
    active = np.array([1.0] * n_active + [0.0] * (n - n_active), np.float32)
    return pts, radii, p0, q0, active


def test_proxies_and_drops_match_jax():
    sv, _ = icosphere(2)
    cv, _ = cube(1.4)
    for v in (sv * SCALE, cv * SCALE * np.array([0.5, 0.5, 1.5], np.float32),
              sv[:5]):
        for a, b in zip(phys.collision_proxies(v),
                        jphys.collision_proxies(v)):
            np.testing.assert_array_equal(a, b)
    xy = np.array([[0.1, 0.2], [0.0, -0.3]], np.float32)
    r = np.array([0.1, 0.05], np.float32)
    for a, b in zip(phys.drop_poses(np.random.default_rng(4), 2, xy, r),
                    jphys.drop_poses(np.random.default_rng(4), 2, xy, r)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,extent", [(0, 0.47), (1, 0.0), (2, 0.2)])
def test_settle_matches_jax_at_100_steps(seed, extent):
    pts, radii, p0, q0, active = _bodies(seed)
    R, t, res = phys.settle_poses(
        pts, radii, p0, q0, active,
        phys.SettleConfig(sim_steps=100, extent=extent), device="cpu")
    jR, jt, jres = jphys.settle_poses(
        jnp.asarray(pts), jnp.asarray(radii), jnp.asarray(p0),
        jnp.asarray(q0), jnp.asarray(active),
        jphys.SettleConfig(sim_steps=100, extent=extent))
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-5)
    assert abs(float(res) - float(jres)) < 1e-5


def test_settler_reuse_and_unroll_are_exact():
    cfg = phys.SettleConfig(sim_steps=60, extent=0.47)
    a = _bodies(0)
    b = _bodies(5, n_active=2)
    settler = phys.Settler(4, 32, cfg, device="cpu")
    assert phys.STEPS_PER_REPLAY == 50
    assert settler.unroll == 10          # gcd(60, 50): 6 replays a settle
    got = [settler.settle(*x) for x in (a, b, a)]
    for x, (R, t, res) in zip((a, b, a), got):
        R0, t0, res0 = phys.settle_poses(*x, cfg, device="cpu")
        assert torch.equal(R, R0) and torch.equal(t, t0)
        assert torch.equal(res, res0)
    assert phys.Settler(4, 32, phys.SettleConfig(), device="cpu").unroll == 50
    # the replays of 10 steps against the steps one at a time
    pts, radii, p0, q0, active = (torch.as_tensor(x) for x in a)
    state = (p0, q0, torch.zeros_like(p0), torch.zeros_like(p0))
    for _ in range(cfg.sim_steps):
        state = phys._step(cfg, *state, pts, radii, active, torch.eye(4),
                           torch.tensor([0.0, 0.0, cfg.gravity * cfg.mass]))
    assert torch.equal(got[0][1], state[0])
    assert torch.equal(got[0][0], quaternion_to_matrix(state[1]))
    with pytest.raises(ValueError):
        phys.Settler(4, 32, cfg, device="cpu", capture=True)


def _settle_single(verts, seed=1, cfg=phys.SettleConfig()):
    pts, com, r = phys.collision_proxies(verts)
    p0, q0 = phys.drop_poses(np.random.default_rng(seed), 1,
                             np.zeros((1, 2), np.float32), np.array([r]))
    R, t, res = phys.settle_poses(pts[None], np.array([r]), p0, q0,
                                  np.ones(1), cfg, device="cpu")
    R, t = R.numpy()[0], t.numpy()[0]
    return R, t, t + pts @ R.T, float(res)


def test_sphere_rests_on_floor():
    sv, _ = icosphere(2)
    R, t, world, res = _settle_single(sv * SCALE)
    assert abs(world[:, 2].min()) < 3e-3
    assert 0.8 * SCALE < t[2] < 1.05 * SCALE
    assert res < 0.15
    assert np.allclose(R @ R.T, np.eye(3), atol=1e-4)


def test_tall_box_topples_to_stable_side():
    cv, _ = cube(1.4)
    box = cv * np.array([0.5, 0.5, 1.5], np.float32) * SCALE
    half_side, half_up = box[:, 0].max(), box[:, 2].max()
    for seed in range(4):
        _, t, world, _ = _settle_single(box, seed=seed)
        assert abs(world[:, 2].min()) < 3e-3
        assert t[2] < 0.6 * half_up, f"seed {seed}: balanced upright"
        assert abs(t[2] - half_side) < 0.35 * half_side


def test_two_bodies_separate():
    sv, _ = icosphere(2)
    pts, _, r = phys.collision_proxies(sv * SCALE)
    xy = np.array([[0.0, 0.0], [0.01, 0.0]], np.float32)
    radii = np.array([r, r], np.float32)
    p0, q0 = phys.drop_poses(np.random.default_rng(0), 2, xy, radii)
    _, t, _ = phys.settle_poses(np.stack([pts, pts]), radii, p0, q0,
                                np.ones(2), phys.SettleConfig(extent=0.5),
                                device="cpu")
    t = t.numpy()
    assert np.linalg.norm(t[0] - t[1]) > 0.9 * 2 * r
    assert np.abs(t[:, :2]).max() < 0.5 + r + 1e-3


def test_inactive_bodies_stay_frozen():
    sv, _ = icosphere(1)
    pts, _, r = phys.collision_proxies(sv * SCALE)
    p0 = np.array([[0.0, 0.0, 0.3], [0.2, 0.0, 0.3]], np.float32)
    q0 = np.tile(np.array([1.0, 0, 0, 0], np.float32), (2, 1))
    R, t, _ = phys.settle_poses(np.stack([pts, pts]), np.array([r, r]), p0,
                                q0, np.array([1.0, 0.0]), device="cpu")
    assert np.array_equal(t.numpy()[1], p0[1])         # frozen exactly
    assert np.allclose(R.numpy()[1], np.eye(3), atol=1e-6)
    assert float(t[0, 2]) < 0.2                         # the active one fell


def test_datagen_physics_mode_matches_jax_at_100_steps():
    """The generator's physics placement, both settles shortened to 100
    steps: the same poses within 1e-5 and a renderable scene resting on
    or above the floor."""
    from torch_renderer_tpu.datagen import coco as jcoco

    kw = dict(image_size=(48, 64), views_per_scene=2,
              objects_per_scene=(2, 3), placement_mode="physics",
              material_mode="vertex", view_chunk=2, normal_maps=False)
    gen = COCODataGenerator(ObjectLibrary.primitives(3, level=1),
                            DataGenConfig(**kw), device="cpu")
    jgen = jcoco.COCODataGenerator(jcoco.ObjectLibrary.primitives(3, level=1),
                                   jcoco.DataGenConfig(**kw))
    gen._settle_cfg = dataclasses.replace(gen._settle_cfg, sim_steps=100)
    jgen._settle_cfg = dataclasses.replace(jgen._settle_cfg, sim_steps=100)
    scene, poses = gen.sample_scene(np.random.default_rng(3))
    _, jposes = jgen.sample_scene(np.random.default_rng(3))
    assert len(poses) == len(jposes)
    for a, b in zip(poses, jposes):
        assert a["category_id"] == b["category_id"]
        np.testing.assert_allclose(a["R"], b["R"], atol=1e-5)
        np.testing.assert_allclose(a["t"], b["t"], atol=1e-5)
    nv = int(scene.meshes.num_verts[0])
    v = scene.meshes.verts[0, :nv].numpy()
    assert np.isfinite(v).all()
    out = gen.render_scene(scene, np.random.default_rng(3))
    assert (out["segmentation"] != 255).any()


def test_datagen_physics_mode_rests_on_floor():
    cfg = DataGenConfig(image_size=(48, 64), views_per_scene=2,
                        objects_per_scene=(2, 3), placement_mode="physics",
                        material_mode="vertex", view_chunk=2,
                        normal_maps=False)
    gen = COCODataGenerator(ObjectLibrary.primitives(3, level=1), cfg,
                            device="cpu")
    scene, poses = gen.sample_scene(np.random.default_rng(3))
    nv = int(scene.meshes.num_verts[0])
    assert scene.meshes.verts[0, :nv, 2].min() > -5e-3
    for pose in poses:
        R = np.asarray(pose["R"], np.float32)
        assert np.allclose(R @ R.T, np.eye(3), atol=1e-3)


def test_bad_placement_mode_raises():
    with pytest.raises(ValueError):
        COCODataGenerator(ObjectLibrary.primitives(1, level=0),
                          DataGenConfig(placement_mode="hover"),
                          device="cpu")

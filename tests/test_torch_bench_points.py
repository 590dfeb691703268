"""Port parity: the point-renderer bench twin
(torch_renderer_tpu_torch/bench_points.py) against the JAX package's
scripts/bench_points.py on the CPU, at the twin's --quick scene (B=2
clouds of 1500 points, 64x64, radius 0.01, K=8, tile 16).

The scene and its four budgets equal the JAX script's suggest_* results
on the same numpy inputs, and the DEFAULT row resolves as JAX's prepare()
does. Each of the nine rows' forward and grad step (d sum(render^2) / dp)
match the JAX renderers built as the script builds them (the binned
"pallas" rows through JAX's Pallas kernel in interpret mode): images
within 1e-5, gradients within 1e-4 of their largest, the tolerances of
tests/test_torch_point_render.py. As there, the JAX reference jits each
rasterization once and runs the compositors op by op (a jitted norm or
sphere blend sums in another order).

The sphere rows' gradients are ill-conditioned at this scene's sub-pixel
spheres (0.2 pixels wide at 64x64): where a sphere is alone on a rim
pixel, rgb = e f / e with e small, and the two terms of the division's
backward cancel in float32, to a sign that depends on the order of
operations. There the port and JAX differ by up to 0.35% of the largest
gradient, on 1.46% of the coordinates, while JAX's own float32 gradient
is 0.90% of the largest from its float64 one (the port's 0.91%) and its
jitted one 2.9% from its op-by-op one. So the sphere rows' gradients are
held to 1e-4 of the largest on all but 2% of the coordinates and to 1e-2
of it everywhere; every other row, and every image, to the tolerances
above. The chained StepGraph body equals a plain loop of the same body;
main() ends in its JSON line.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_renderer_tpu as jtrt
from torch_renderer_tpu.rasterize import points as jpoints
from torch_renderer_tpu.structures.pointclouds import Pointclouds as JClouds
from torch_renderer_tpu_torch import bench_points as bp

Q = bp.QUICK
B, N, S = Q["batch"], Q["points"], Q["image"]
# the JAX script's rows, by its names
ROWS = [bp.DENSE, "alpha (DEFAULT auto)", "alpha (binned xla)",
        "alpha (binned pallas)", "alpha (binned pallas+act)",
        "norm (binned)", "pulsar_splat (binned)", "pulsar_sphere (binned)",
        "pulsar_sphere (binned+act)"]
SPHERES = ("pulsar_sphere (binned)", "pulsar_sphere (binned+act)")
SPHERE_SHARE = 0.02   # of the sphere rows' gradient coordinates beyond tol
SPHERE_TOL = 1e-2     # the sphere rows' gradient, of its largest


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _arrays():
    """The JAX script's draws."""
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((B, N, 3)).astype(np.float32) * 0.8
    feats = rng.uniform(0.0, 1.0, (B, N, 3)).astype(np.float32)
    return pts, feats


def _jax_scene():
    pts, feats = _arrays()
    pcd = JClouds(points=jnp.asarray(pts),
                  num_points=jnp.full((B,), N, jnp.int32),
                  features=jnp.asarray(feats))
    f = 0.8 * S
    K = np.array([[f, 0, S / 2.0], [0, f, S / 2.0], [0, 0, 1.0]], np.float32)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3))
    t = np.tile(np.array([0.0, 0.0, 2.5], np.float32), (B, 1))
    return pcd, K, R, t


@pytest.fixture(scope="module")
def port_scene():
    cloud, K, R, t = bp.scene(B, N, S, "cpu")
    bud = bp.size_budgets(cloud, K, R, t, S, "cpu")
    rows, auto = bp.make_renderers(cloud, K, R, t, S, bud, "cpu")
    return cloud, K, R, t, bud, rows, auto


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX script's budgets, DEFAULT resolution and renderers, and
    each row's image and gradient of sum(render^2) to the points."""
    from torch_renderer_tpu.renderer import (
        AlphaPointRender,
        NormPointRender,
        PulsarPointRender,
        PulsarRenderer,
    )

    pcd, K, R, t = _jax_scene()
    probe = jpoints.PointsRasterizationSettings(
        image_size=(S, S), radius=0.01, bin_size=16)
    cam = AlphaPointRender(K, (S, S)).camera_with_pose(R, t)
    sph = PulsarRenderer(K, (S, S), radius=0.01, bin_size=16)
    cam_s = sph.camera_with_pose(R, t)
    pts_cam = cam_s.world_to_camera(pcd.points)
    fmax = jnp.maximum(cam_s.fx, cam_s.fy)[:, None]
    r_ndc = 0.01 * fmax / (cam_s.ndc_scale * jnp.maximum(
        pts_cam[..., 2] - 0.01, sph.settings.znear))
    bud = {"mpb": jpoints.suggest_points_per_bin(pcd, cam, probe),
           "mpb_sphere": jpoints.suggest_points_per_bin(
               pcd, cam_s, probe, radius=r_ndc),
           "act": jpoints.suggest_active_tiles_points(pcd, cam, probe),
           "act_sphere": jpoints.suggest_active_tiles_points(
               pcd, cam_s, probe, radius=r_ndc)}
    bkw = dict(radius=0.01, bin_size=16, max_points_per_bin=bud["mpb"])
    default_r = AlphaPointRender(K, (S, S), radius=0.01)
    st_auto = default_r.prepare(pcd, R, t)
    renderers = {
        bp.DENSE: AlphaPointRender(K, (S, S), radius=0.01, bin_size=0),
        "alpha (DEFAULT auto)": default_r,
        "alpha (binned xla)": AlphaPointRender(K, (S, S), impl="xla", **bkw),
        "alpha (binned pallas)": AlphaPointRender(
            K, (S, S), impl="pallas", **bkw),
        "alpha (binned pallas+act)": AlphaPointRender(
            K, (S, S), impl="pallas", active_tiles=bud["act"], **bkw),
        "norm (binned)": NormPointRender(K, (S, S), **bkw),
        "pulsar_splat (binned)": PulsarPointRender(K, (S, S), **bkw),
        "pulsar_sphere (binned)": PulsarRenderer(
            K, (S, S), radius=0.01, bin_size=16,
            max_points_per_bin=bud["mpb_sphere"]),
        "pulsar_sphere (binned+act)": PulsarRenderer(
            K, (S, S), radius=0.01, bin_size=16,
            max_points_per_bin=bud["mpb_sphere"],
            active_tiles=bud["act_sphere"]),
    }
    jraster = jax.jit(jpoints.rasterize_points, static_argnums=2)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpoints, "rasterize_points",
                   lambda pcls, cam, st, radius=None, extra=None: jraster(
                       pcls, cam, st, radius, extra))
        for name, r in renderers.items():
            def render(p, r=r):
                return r.render(dataclasses.replace(pcd, points=p), R, t)

            img, vjp = jax.vjp(render, pcd.points)
            (g,) = vjp(2.0 * img)      # d sum(img^2) / dp
            out[name] = (np.asarray(img), np.asarray(g))
    return {"budgets": bud, "auto": st_auto, "rows": out}


def test_scene_is_the_jax_scripts(port_scene):
    cloud, K, R, t = port_scene[:4]
    pts, feats = _arrays()
    _, Kj, Rj, tj = _jax_scene()
    np.testing.assert_array_equal(cloud.points.numpy(), pts)
    np.testing.assert_array_equal(cloud.features.numpy(), feats)
    np.testing.assert_array_equal(cloud.num_points.numpy(), [N] * B)
    np.testing.assert_array_equal(K, Kj)
    np.testing.assert_array_equal(R.numpy(), Rj)
    np.testing.assert_array_equal(t.numpy(), tj)


def test_budgets_and_default_resolution_match_jax(port_scene, jax_ref):
    bud, rows, auto = port_scene[4:]
    assert bud == jax_ref["budgets"]
    ja = jax_ref["auto"]
    assert (auto.bin_size, auto.max_points_per_bin, auto.active_tiles) == (
        ja.bin_size, ja.max_points_per_bin, ja.active_tiles)
    assert list(rows) == list(jax_ref["rows"]) == ROWS


@pytest.mark.parametrize("body", bp.BODIES)
@pytest.mark.parametrize("row", ROWS)
def test_row_matches_jax(port_scene, jax_ref, row, body):
    cloud, _, R, t, _, rows, _ = port_scene
    fn = bp.bodies(rows[row], cloud, R, t)[body]
    got = fn(cloud.points).detach().numpy()
    img, grad = jax_ref["rows"][row]
    if body == "forward":
        assert got.shape == img.shape == (B, S, S, 4)
        assert img[..., 3].max() > 0.5
        np.testing.assert_allclose(got, img, rtol=0, atol=1e-5)
        return
    assert np.isfinite(got).all() and np.abs(grad).max() > 0
    tol = 1e-4 * np.abs(grad).max()
    if row not in SPHERES:
        np.testing.assert_allclose(got, grad, rtol=0, atol=tol)
        return
    # the sphere blend's gradient is ill-conditioned (module docstring):
    # within tol on all but SPHERE_SHARE of the coordinates, within
    # SPHERE_TOL of the largest everywhere
    err = np.abs(got - grad)
    assert (err > tol).mean() <= SPHERE_SHARE
    assert err.max() <= SPHERE_TOL * np.abs(grad).max()


@pytest.mark.parametrize("body", bp.BODIES)
def test_chained_step_graph_equals_plain_loop(port_scene, body):
    cloud, _, R, t, _, rows, _ = port_scene
    fn = bp.bodies(rows["pulsar_sphere (binned+act)"], cloud, R, t)[body]
    chain = bp.Chain(fn, cloud.points)        # the CPU: eager
    assert not chain.captured
    c = cloud.points.clone()
    for _ in range(2):
        out = fn(c)
        c = c + 1e-30 * out.sum()
        got = chain.step()
        assert torch.equal(got, out)
        assert torch.equal(chain.c, c)
    with pytest.raises(ValueError, match="CUDA"):
        bp.Chain(fn, cloud.points, capture=True)


def _table(text: str) -> list:
    return [line.split("|")[1].strip() for line in text.splitlines()
            if line.startswith("| ") and "renderer" not in line]


def test_main_quick_cpu(capsys):
    out = bp.main(["--quick", "--device", "cpu", "--steps", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert last["n_chips"] == 1 and set(last) == {"rows", "floor_ms",
                                                  "n_chips"}
    assert list(last["rows"]) == _table("\n".join(lines)) == list(
        out["rows"])
    assert list(last["rows"]) == ROWS
    for row in last["rows"].values():
        assert row["form"] == "eager"
        assert np.isfinite([row["forward_ms"], row["grad_step_ms"]]).all()
    assert lines[0].startswith("device: cpu")
    assert "auto max_points_per_bin = " in lines[1]
    eager = bp.main(["--quick", "--device", "cpu", "--steps", "1", "--eager",
                     "--skip-dense"])
    text = capsys.readouterr().out
    assert _table(text) == list(eager["rows"]) == list(out["rows"])[1:]
    assert json.loads(text.strip().splitlines()[-1])["rows"][
        "norm (binned)"]["form"] == "eager"

"""The port's depth-render apps and their host modules against the JAX
package on the CPU: the recorded-frame fixtures (io/fixtures.py), the
float64 ray caster (baselines.py), the standard-library PNG writer
(io/png.py) and the apps quick_render, render_compare and
object_pose_from_depth, run in process.

Tolerances: the fixtures' arrays equal JAX's (the same numpy code); the
ray caster's depth equal to JAX's bit for bit (the same float64 numpy
code). The port's DepthRender against the ray caster, as
tests/test_oracle_raytrace.py holds the JAX rasterizer: coverage IoU above
0.99 and interior depth within 2e-3 (edge pixels differ by sub-pixel
sampling); a 4-pixel principal-point error must break that comparison.
"""

import os
import pickle
import zlib

import numpy as np
import pytest
import torch

from torch_renderer_tpu.baselines import raytrace_depth as jax_raytrace
from torch_renderer_tpu.io.fixtures import (
    load_recorded_frames as jax_load_recorded_frames,
)
from torch_renderer_tpu_torch import baselines
from torch_renderer_tpu_torch.apps import (
    object_pose_from_depth,
    quick_render,
    render_compare,
)
from torch_renderer_tpu_torch.io.fixtures import (
    load_recorded_frames,
    save_recorded_frames,
)
from torch_renderer_tpu_torch.io.png import write_png
from torch_renderer_tpu_torch.ops.icosphere import icosphere
from torch_renderer_tpu_torch.rasterize.binning import (
    set_budget_check_default,
)
from torch_renderer_tpu_torch.renderer import DepthRender
from torch_renderer_tpu_torch.structures.meshes import Meshes

# tests/test_oracle_raytrace.py's camera: non-square, fx != fy, the
# principal point off centre
H, W = 48, 64
K_MAT = np.array([[70.0, 0.0, 25.0], [0.0, 65.0, 27.0], [0.0, 0.0, 1.0]],
                 np.float32)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module: the suite runs several workers
    on one machine, where torch's default of one thread per core
    oversubscribes it and the fits slow down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pose():
    c, s = np.cos(np.radians(20.0)), np.sin(np.radians(20.0))
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    t = np.array([0.05, -0.03, 2.8], np.float32)
    return R, t


def _frames(rng):
    """tests/test_fixtures.py's three frames."""
    frames = []
    for i in range(3):
        ext = np.eye(4, dtype=np.float32)
        ext[:3, 3] = rng.standard_normal(3)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [0.1 * i, 0, 0.5]
        frames.append({
            "object_id": i, "object_pose": pose, "extrinsic": ext,
            "intrinsic": np.diag([100.0, 100.0, 1.0]).astype(np.float32),
            "rendered_depth": rng.uniform(0, 2, (18, 32)).astype(np.float32),
        })
    return frames


def test_recorded_frames_match_jax(tmp_path):
    frames = _frames(np.random.default_rng(0))
    path = str(tmp_path / "rec.pkl")
    save_recorded_frames(path, frames)
    with open(path, "rb") as f:
        assert len(pickle.load(f)) == 3
    got, want = load_recorded_frames(path), jax_load_recorded_frames(path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["K"].shape == (3, 3, 3) and got["depth"].shape == (3, 18, 32)
    assert list(got["object_id"]) == [0, 1, 2]
    # the camera chain: extrinsic @ object_pose (pose_optimizer.py:91)
    chain = frames[1]["extrinsic"] @ frames[1]["object_pose"]
    np.testing.assert_allclose(got["R"][1], chain[:3, :3], atol=1e-6)
    np.testing.assert_allclose(got["t"][1], chain[:3, 3], atol=1e-6)


def test_raytrace_equals_jax_bit_for_bit():
    verts, faces = icosphere(2)
    R, t = _pose()
    got = baselines.raytrace_depth(verts, faces, K_MAT, R, t, (H, W))
    want = jax_raytrace(verts, faces, K_MAT, R, t, (H, W))
    assert got.dtype == np.float64 and (got > 0).mean() > 0.1
    np.testing.assert_array_equal(got, want)
    ext = np.eye(4)
    ext[:3, :3], ext[:3, 3] = R, t
    np.testing.assert_array_equal(
        baselines.VisRaytrace((H, W)).quick_depth_render(verts, faces, K_MAT,
                                                         ext), want)


def _port_depth(verts, faces, K, R, t, **settings):
    meshes = Meshes.from_single(verts, faces, device="cpu")
    return DepthRender(K, (H, W), device="cpu", **settings).render(
        meshes, torch.from_numpy(R)[None], torch.from_numpy(t)[None]
    )[0].numpy()


def _compare(depth_rast, depth_ray, iou_min=0.99, depth_tol=2e-3):
    """tests/test_oracle_raytrace.py's comparison."""
    cov_a, cov_b = depth_rast > 0, depth_ray > 0
    iou = (cov_a & cov_b).sum() / max(1, (cov_a | cov_b).sum())
    assert iou > iou_min, f"coverage IoU {iou:.4f}"
    both = cov_a & cov_b
    interior = both.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            interior &= np.roll(both, (dy, dx), axis=(0, 1))
    interior[0, :] = interior[-1, :] = False
    interior[:, 0] = interior[:, -1] = False
    assert interior.sum() > 50
    err = np.abs(depth_rast - depth_ray)[interior]
    assert err.max() < depth_tol, f"max interior depth err {err.max():.2e}"


@pytest.mark.parametrize("settings", [
    {"bin_size": 0},                                 # dense selection
    {"bin_size": 16, "max_faces_per_bin": 256},      # binned
    {"bin_size": 16, "max_faces_per_bin": 256, "impl": "pallas"},
])
def test_depth_render_matches_raytrace(settings):
    verts, faces = icosphere(2)
    R, t = _pose()
    _compare(_port_depth(verts, faces, K_MAT, R, t, **settings),
             baselines.raytrace_depth(verts, faces, K_MAT, R, t, (H, W)))


def test_raytrace_catches_principal_point_error():
    verts, faces = icosphere(2)
    R, t = _pose()
    K_bad = K_MAT.copy()
    K_bad[0, 2] += 4.0
    want = baselines.raytrace_depth(verts, faces, K_MAT, R, t, (H, W))
    with pytest.raises(AssertionError):
        _compare(_port_depth(verts, faces, K_bad, R, t), want)


def test_cow_matches_raytrace():
    """The reference's cow mesh (in the directory TRT_REFERENCE_DATA names,
    as cow_mesh/cow.obj) through the binned path against the ray caster;
    skipped without it."""
    root = os.environ.get("TRT_REFERENCE_DATA", "")
    path = os.path.join(root, "cow_mesh", "cow.obj")
    if not root or not os.path.exists(path):
        pytest.skip("reference assets not available")
    from torch_renderer_tpu_torch.io.obj import load_obj

    o = load_obj(path, load_textures=False)
    R = np.eye(3, dtype=np.float32)
    t = np.array([0.0, 0.0, 0.35], np.float32)
    Kc = np.array([[90.0, 0.0, 30.0], [0.0, 85.0, 26.0], [0.0, 0.0, 1.0]],
                  np.float32)
    got = _port_depth(o.verts, o.faces, Kc, R, t, bin_size=16,
                      max_faces_per_bin=2176)
    _compare(got, baselines.raytrace_depth(o.verts, o.faces, Kc, R, t,
                                           (H, W)), iou_min=0.97)


def _read_png(path):
    """Pixels of a PNG whose rows are unfiltered (what write_png writes)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag = data[pos + 4:pos + 8]
        chunks[tag] = chunks.get(tag, b"") + data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w = int.from_bytes(chunks[b"IHDR"][0:4], "big")
    h = int.from_bytes(chunks[b"IHDR"][4:8], "big")
    c = {0: 1, 2: 3, 6: 4}[chunks[b"IHDR"][9]]
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + w * c)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, c)


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 3), (4, 6, 4)])
def test_png_round_trip(tmp_path, shape):
    img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    np.testing.assert_array_equal(_read_png(path).reshape(shape), img)
    PIL = pytest.importorskip("PIL.Image")
    np.testing.assert_array_equal(np.asarray(PIL.open(path)), img)


@pytest.fixture
def app_budget_default():
    """The apps set the process-wide budget-check default for their run;
    put the default (None) back, so later tests in this process see it."""
    yield
    set_budget_check_default(None)


def test_quick_render_runs(tmp_path, capsys, app_budget_default):
    out = quick_render.main(["--device", "cpu", "--image-size", "64",
                             "--frames", "3", "--out-dir", str(tmp_path)])
    assert "wrote 3 rgb+depth frames" in capsys.readouterr().out
    assert 0.1 < out["coverage"] < 0.9
    for i in range(3):
        rgb = _read_png(str(tmp_path / f"rgb_{i:03d}.png"))
        depth = _read_png(str(tmp_path / f"depth_{i:03d}.png"))
        assert rgb.shape == (64, 64, 3) and depth.shape == (64, 64, 1)
        np.testing.assert_array_equal(
            rgb, (np.clip(out["rgb"][i], 0, 1) * 255).astype(np.uint8))
        assert depth.max() == 255


def test_render_compare_runs(capsys, app_budget_default):
    out = render_compare.main(["--device", "cpu", "--image-size", "48",
                               "--check-budgets", "warn"])
    text = capsys.readouterr().out
    assert "cross-renderer gate" in text
    worst = float(text.rsplit("worst interior |diff|", 1)[1].split()[0])
    assert worst < 2e-3 and out["worst"] < 2e-3
    np.testing.assert_array_equal(out["ours"], out["recorded"])


@pytest.mark.parametrize("extra", [[], ["--object-pose"]])
def test_object_pose_from_depth_runs(extra, tmp_path, capsys,
                                     app_budget_default):
    """Both modes on a 64x64 recording of the app's demo view (the demo
    records 160x160)."""
    from torch_renderer_tpu_torch.apps._common import pinhole_K
    from torch_renderer_tpu_torch.cameras.look_at import (
        look_at_view_transform,
    )

    verts, faces = icosphere(3)
    meshes, _, _ = Meshes.from_single(
        verts, faces, device="cpu").center_and_scale_to_unit_sphere()
    K = pinhole_K((64, 64))
    R, t = look_at_view_transform(2.6, 25.0, 35.0)
    ext = np.eye(4, dtype=np.float32)
    ext[:3, :3], ext[:3, 3] = R[0].numpy(), t[0].numpy()
    depth = DepthRender(K, (64, 64), device="cpu").render(meshes, R, t)
    path = str(tmp_path / "rec.pkl")
    save_recorded_frames(path, [{
        "object_id": 0, "object_pose": np.eye(4, dtype=np.float32),
        "extrinsic": ext, "intrinsic": K,
        "rendered_depth": depth[0].numpy()}])
    out = object_pose_from_depth.main(["--device", "cpu", "--pickle", path,
                                       "--iters", "12", "--lr", "5e-3"]
                                      + extra)
    text = capsys.readouterr().out
    assert "translation err" in text
    losses = out["losses"]
    assert losses.shape == (12,) and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    err0, err1 = out["err"]
    assert err1 < err0


@pytest.mark.parametrize("app", [quick_render, render_compare,
                                 object_pose_from_depth])
def test_cuda_without_card_raises(app):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(["--device", "cuda"])

"""Port parity: the batched multi-view depth render (apps/batch_render_bench)
of torch_renderer_tpu_torch against the JAX package, on the CPU, and the
port's timing harness (utils/timing.py).

The app's configuration, cut to 72x128 (a 3x4 grid of 32-pixel tiles whose
last row is cropped), 3 views and a level-2 icosphere: look-at views at
distance 2.7, elevation 15, azimuths 0/120/240, f = 0.9 * 72, bin 32, auto
max_faces_per_bin, active_tiles and occupancy_split, select_impl="affine".
The JAX side runs its XLA binned path (bin 32 never takes its Pallas
kernels); the port runs its kernels' plain versions (tile gather, K=1
selection, untile). The port ignores the split, which drops nothing here.

Tolerances: the budgets and the occupancy split are equal (integer
bookkeeping). Depth within 1e-5; only pixels whose winners differ at a
selection-depth tie (the JAX affine keys order ties otherwise, as measured
for the K=1 kernel) may differ more, on at most 0.1% of covered pixels. The
silhouette within 1e-4, the bound of tests/test_torch_shading.py: it is
sigmoid(-dists / 1e-4), which scales float32 rounding of the distances by
1e4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_renderer_tpu_torch as port
from torch_renderer_tpu.cameras.look_at import look_at_view_transform
from torch_renderer_tpu.cameras.perspective import PerspectiveCamera
from torch_renderer_tpu.ops.icosphere import icosphere
from torch_renderer_tpu.rasterize import binning as jb
from torch_renderer_tpu.rasterize.geometry import setup_faces
from torch_renderer_tpu.renderer import DepthRender
from torch_renderer_tpu.structures.meshes import Meshes
from torch_renderer_tpu_torch import interop
from torch_renderer_tpu_torch.apps import batch_render_bench
from torch_renderer_tpu_torch.rasterize import binning as pb
from torch_renderer_tpu_torch.utils import timing

H, W, N, TILE = 72, 128, 3, 32


def _intrinsics(size):
    f = 0.9 * min(size)
    return np.array([[f, 0, size[1] / 2], [0, f, size[0] / 2], [0, 0, 1]],
                    np.float32)


@pytest.fixture(scope="module")
def scene():
    """(JAX meshes, R, t) of the app's views of the normalized level-2
    icosphere (numpy R, t; the port takes the same arrays)."""
    m = Meshes.from_single(*icosphere(2))
    m, _, _ = m.center_and_scale_to_unit_sphere()
    R, t = look_at_view_transform(
        2.7, 15.0, jnp.linspace(0.0, 360.0, N, endpoint=False))
    return m, np.array(R), np.array(t)


def _face_data(scene, size):
    m, R, t = scene
    fd = setup_faces(m.extend(N), PerspectiveCamera.from_K(
        _intrinsics(size), size, R=R, t=t))
    return fd, interop.face_raster_data_from_arrays(
        *(np.asarray(getattr(fd, f.name)) for f in dataclasses.fields(fd)),
        device="cpu")


# (image size, tile, max_faces_per_bin, active_tiles): the app's own (the
# split comes back None) and two that split the tiles
@pytest.mark.parametrize("size,tile,mfb,act", [
    ((H, W), TILE, 163, 8), ((72, 128), 16, 128, 40),
    ((72, 128), 8, 64, 100)])
def test_occupancy_split_matches_jax(scene, size, tile, mfb, act):
    fd, pfd = _face_data(scene, size)
    want = jb.suggest_occupancy_split_fd(fd, size, tile, 0.0, act, mfb)
    got = pb.suggest_occupancy_split_fd(pfd, size, tile, 0.0, act, mfb)
    assert got == want
    assert (want is None) == (tile == TILE)


def test_app_configuration_matches_jax(scene):
    m, R, t = scene
    fd, pfd = _face_data(scene, (H, W))
    jmax, _ = jb.count_overflow(fd, (H, W), TILE, 0, 0.0)
    pmax, _ = pb.count_overflow(pfd, (H, W), TILE, 0, 0.0)
    assert int(pmax) == int(jmax)
    mfb = max(8, int(float(jmax) * 1.3))
    act = jb.suggest_active_tiles_fd(fd, (H, W), TILE, 0.0)
    assert pb.suggest_active_tiles_fd(pfd, (H, W), TILE, 0.0) == act
    split = jb.suggest_occupancy_split_fd(fd, (H, W), TILE, 0.0, act, mfb)
    kw = dict(pixel_chunk=1048576, bin_size=TILE, max_faces_per_bin=mfb,
              active_tiles=act, occupancy_split=split, select_impl="affine")
    K = _intrinsics((H, W))
    jr = DepthRender(K, (H, W), **kw)
    jd, js = jax.jit(lambda mm, RR, tt: jr.render(
        mm, RR, tt, return_silhouette=True))(m.extend(N), R, t)
    jd, js = np.asarray(jd), np.asarray(js)
    pm = port.Meshes.from_single(np.asarray(m.verts[0]),
                                 np.asarray(m.faces[0]), device="cpu")
    pd, ps = port.DepthRender(K, (H, W), device="cpu", **kw).render(
        pm.extend(N), torch.from_numpy(R), torch.from_numpy(t),
        return_silhouette=True)
    pd, ps = pd.numpy(), ps.numpy()
    assert pd.shape == jd.shape == (N, H, W)
    covered = int((jd > 0).sum())
    assert covered > 0.1 * jd.size
    off = np.abs(pd - jd) > 1e-5
    assert off.sum() <= 1e-3 * covered
    np.testing.assert_allclose(ps[~off], js[~off], rtol=0, atol=1e-4)


def test_main_runs_on_cpu(capsys):
    out = batch_render_bench.main([
        "--device", "cpu", "--n-views", "4", "--view-chunk", "2",
        "--height", "72", "--width", "128", "--reps", "1"])
    text = capsys.readouterr().out
    for line in ("auto max_faces_per_bin = ", "auto active_tiles = ",
                 "batched depth render 4x72x128 (chunks of 2): mean ",
                 "depth images/sec (batched)", "serial single-view render",
                 "serial-equivalent: ", "depth stats: shape (2, 72, 128)"):
        assert line in text, line
    # 2 chunks x (1 warm-up + 1 rep), 1 + 1 serial calls, 1 final render
    assert out["calls"] == 7
    assert out["images_per_s"] > 0 and 0.05 < out["coverage"] < 0.9
    assert 2.0 < out["depth_max"] < 3.0


def test_time_fn_and_stage_timer_on_cpu():
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": [x * 2.0, x + 1.0]}

    res = timing.time_fn(fn, torch.ones(4), reps=3, warmup=2, name="double")
    assert len(calls) == 1 + 1 + 3
    assert res.reps == 3 and res.min_s <= res.mean_s <= res.max_s
    assert str(res).startswith("double: mean ") and "(n=3, compile " in str(
        res)
    timer = timing.StageTimer()
    for _ in range(2):
        with timer.stage("a", sync=torch.zeros(2)):
            pass
    with timer.stage("b"):
        pass
    assert list(timer.stages) == ["a", "b"]
    report = timer.report().splitlines()
    assert report[0].startswith("total ") and report[1].startswith("  a: ")
    with timing.profiler_trace(None):
        pass

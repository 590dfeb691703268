"""The port's benchmark (torch_renderer_tpu_torch/bench.py, the twin of
bench.py) on the CPU: its quick run ends in bench.py's five-key line,
leaves the tracked CPU baseline untouched and imports no JAX; and one of its
steps at the quick scene equals bench.py's step (the JAX package's
jax.grad of the same loss, Pallas in interpret mode) within 2e-3 of the
largest gradient (float32 sums in another order, the port's product-form
backward against JAX's moment form).
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from torch_renderer_tpu.cameras.perspective import PerspectiveCamera
from torch_renderer_tpu.ops.icosphere import icosphere
from torch_renderer_tpu.rasterize.geometry import setup_face_planes
from torch_renderer_tpu.rasterize.pallas_soft import (
    soft_silhouette_pallas_fd,
    suggest_soft_config,
)
from torch_renderer_tpu.structures.meshes import Meshes
from torch_renderer_tpu_torch import bench

REPO = Path(__file__).resolve().parents[1]
BASELINE = REPO / ".bench_cpu_baseline.json"


def test_quick_run_prints_bench_line():
    before = BASELINE.read_bytes()
    code = ("import runpy, sys\n"
            "sys.argv = ['bench', '--quick', '--device', 'cpu']\n"
            "runpy.run_module('torch_renderer_tpu_torch.bench', "
            "run_name='__main__')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'torch_renderer_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    rec = json.loads(lines[-1])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "n_chips"}
    assert rec["metric"] == "softsil_256_render_backward_fps_per_chip"
    assert rec["unit"] == "images/s" and rec["n_chips"] == 1
    assert rec["value"] > 0 and rec["vs_baseline"] is None
    assert any(line.startswith("passes") for line in lines)
    assert any(line.startswith("launches per step") for line in lines)
    assert BASELINE.read_bytes() == before


def test_step_matches_bench_step():
    p = bench.QUICK
    B, img = p["batch"], p["image"]
    meshes, cam = bench.scene(B, img, p["level"], "cpu")
    step, cfg = bench.make_step(meshes, cam)
    v1, g = step(meshes.verts)

    # bench.py:66-103 at the quick scene
    verts, faces = icosphere(p["level"])
    f = 0.8 * img
    K = np.array([[f, 0, img / 2.0], [0, f, img / 2.0], [0, 0, 1.0]],
                 np.float32)
    jm = Meshes.from_single(verts, faces).extend(B)
    jc = PerspectiveCamera.from_K(
        np.tile(K[None], (B, 1, 1)), (img, img),
        R=np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)),
        t=np.tile(np.array([0.0, 0.0, 3.0], np.float32), (B, 1)))
    jcfg = suggest_soft_config(setup_face_planes(jm, jc), (img, img),
                               sigma=bench.SIGMA, layout="packed")
    assert tuple(cfg) == tuple(jcfg)

    def loss_fn(v):
        fp = setup_face_planes(jm.update_padded(v), jc)
        return jnp.sum(soft_silhouette_pallas_fd(
            fp, (img, img), sigma=bench.SIGMA, **jcfg.kwargs()))

    want = np.asarray(jax.jit(jax.grad(loss_fn))(jm.verts))
    got = g.numpy()
    assert np.abs(want).max() > 0 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-3 * np.abs(want).max())
    np.testing.assert_array_equal(v1.numpy(),
                                  (meshes.verts - 1e-6 * g).numpy())

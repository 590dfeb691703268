"""The port's finite-difference pose fit (opt/pose_fit_fd.py) against the
JAX package on the CPU, at tests/test_component_parity.py's scene: 48x48,
f = 0.9 * 48, the level-1 icosphere (80 faces, the dense raster) and the
level-2 one (320 faces, the binned raster's plain versions on the CPU),
step 0.02, eps 2e-3, start [0.05, -0.04, 0] / [0.08, -0.06, 3.15] against
the truth [0, 0, 0] / [0, 0, 3].

Tolerances: depth within 1e-5 and the loss within 1e-5 (the same raster
arithmetic, float32); one central-difference gradient within 5e-3 of its
largest component (each component divides a loss difference by 2 eps =
4e-3, which magnifies the last bits of a loss); one fit step's parameters
within 1e-5 with the same accept decision. The trajectory is not held to
JAX's step for step (an accept/reject decision can flip on a bit); the
40-step fit is held to tests/test_component_parity.py's gates. The loop's
static form (parameters updated in place, the history at a device step
counter) equals a plain Python loop of the same step bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_renderer_tpu.ops.icosphere import icosphere as jicosphere
from torch_renderer_tpu.opt import pose_fit_fd as jfd
from torch_renderer_tpu.structures.meshes import Meshes as JMeshes
from torch_renderer_tpu_torch.opt import pose_fit_fd as fd
from torch_renderer_tpu_torch.structures.meshes import Meshes

IMAGE = (48, 48)
F = 0.9 * IMAGE[0]
K = np.array([[F, 0, 24], [0, F, 24], [0, 0, 1]], np.float32)
GT = ([0.0, 0.0, 0.0], [0.0, 0.0, 3.0])
START = ([0.05, -0.04, 0.0], [0.08, -0.06, 3.15])
EPS = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(mod):
    return mod.FDPoseFitConfig(step_size=0.02, eps=EPS)


def _pack(*aa_t):
    return fd.FiniteDifferencePoseFitter.pack(*aa_t, device="cpu")


@pytest.fixture(scope="module", params=[1, 2], ids=["dense", "binned"])
def scene(request):
    """Both fitters on one mesh, and JAX's numbers of it, each function
    jitted once: the reference depth and the depth at the start (auto
    settings resolved at the truth first, as the port's first render
    does), the loss and the gradient at the start, and (the dense scene,
    tests/test_component_parity.py's) one fit step."""
    verts, faces = jicosphere(request.param)
    jf = jfd.FiniteDifferencePoseFitter(K, IMAGE, _config(jfd))
    jm = JMeshes.from_single(verts, faces)
    gt, start = jf.pack(*GT), jf.pack(*START)
    R, t = jf.unpack(gt)
    jf.renderer.prepare(jm, R[None], t[None])
    depth = jax.jit(lambda p: jf.render_depth(jm, p))
    jref = depth(gt)
    want = {"ref": np.asarray(jref), "depth": np.asarray(depth(start)),
            "loss": float(jax.jit(lambda p: jf.loss(p, jm, jref))(start)),
            "grad": np.asarray(jax.jit(lambda p: jfd.finite_difference_grad(
                lambda q: jf.loss(q, jm, jref), p, EPS))(start)),
            "step": jf.fit(jm, jref, start, n_steps=1)
            if request.param == 1 else None}
    tf = fd.FiniteDifferencePoseFitter(K, IMAGE, _config(fd), device="cpu")
    tm = Meshes.from_single(verts, faces, device="cpu")
    return want, tf, tm


def test_finite_difference_grad_matches_analytic_and_jax():
    A = np.random.default_rng(0).standard_normal((4, 4)).astype(np.float32)
    A = A @ A.T + np.eye(4, dtype=np.float32)
    x = np.array([0.3, -0.5, 0.8, 0.1], np.float32)
    At = torch.tensor(A)
    ours = fd.finite_difference_grad(lambda p: 0.5 * p @ At @ p,
                                     torch.tensor(x), eps=1e-3)
    theirs = jfd.finite_difference_grad(lambda p: 0.5 * p @ A @ p,
                                        jnp.asarray(x), eps=1e-3)
    np.testing.assert_allclose(ours.numpy(), A @ x, atol=1e-2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-3)


def test_render_depth_and_loss_match_jax(scene):
    want, tf, tm = scene
    ref = tf.render_depth(tm, _pack(*GT))
    np.testing.assert_allclose(ref.numpy(), want["ref"], atol=1e-5, rtol=0)
    start = _pack(*START)
    np.testing.assert_allclose(tf.render_depth(tm, start).numpy(),
                               want["depth"], atol=1e-5, rtol=0)
    ref = torch.tensor(want["ref"])
    assert abs(float(tf.loss(start, tm, ref)) - want["loss"]) <= 1e-5
    # the batched loss is the per-pose loss, row by row
    rows = fd._fd_rows(start, EPS)
    batched = tf.loss(rows, tm, ref)
    assert batched.shape == (12,)
    for i in (0, 5, 11):
        assert float(batched[i]) == float(tf.loss(rows[i], tm, ref))


def test_fd_gradient_matches_jax(scene):
    want, tf, tm = scene
    ours = fd._fd_combine(tf.loss(fd._fd_rows(_pack(*START), EPS), tm,
                                  torch.tensor(want["ref"])), EPS).numpy()
    theirs = want["grad"]
    assert np.abs(ours - theirs).max() <= 5e-3 * np.abs(theirs).max()


@pytest.mark.parametrize("scene", [1], ids=["dense"], indirect=True)
def test_one_fit_step_matches_jax(scene):
    want, tf, tm = scene
    jp, jh = want["step"]
    tp, th = tf.fit(tm, torch.tensor(want["ref"]), _pack(*START), n_steps=1)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(th["loss"].numpy(), np.asarray(jh["loss"]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(th["grad_norm"].numpy(),
                               np.asarray(jh["grad_norm"]), rtol=5e-3)
    moved = [not np.array_equal(p, np.asarray(_pack(*START)))
             for p in (tp.numpy(), np.asarray(jp))]
    assert moved[0] == moved[1]


def test_fd_pose_fit_improves(scene, request):
    """tests/test_component_parity.py's gates on a 40-step fit of its own
    scene (the dense one; the binned scene runs 15 steps)."""
    want, tf, tm = scene
    n = 40 if "dense" in request.node.name else 15
    start = _pack(*START)
    ref = torch.tensor(want["ref"])
    params, hist = tf.fit(tm, ref, start, n_steps=n)
    losses = hist["loss"].numpy()
    assert losses.shape == (n,) and np.isfinite(losses).all()
    assert losses[-1] < float(tf.loss(start, tm, ref))
    # every step keeps or lowers the loss
    assert (np.diff(losses) <= 0).all()
    err0 = np.linalg.norm(np.array(START[1]) - np.array(GT[1]))
    err1 = np.linalg.norm(params[3:].numpy() - np.array(GT[1]))
    assert err1 < err0


def test_fit_static_loop_equals_plain_loop(scene, monkeypatch):
    """The fit's static form against a plain loop of the same step (a new
    params tensor each step, history stacked by the host), bit for bit;
    each step rasterizes twice, 12 views then 2 (on the card: two launches
    of each of the raster's kernels)."""
    want, tf, tm = scene
    ref = torch.tensor(want["ref"])
    calls = []
    raster = fd.rasterize_meshes

    def counted(meshes, cam, settings):
        calls.append(meshes.batch_size)
        return raster(meshes, cam, settings)

    monkeypatch.setattr(fd, "rasterize_meshes", counted)
    params, hist = tf.fit(tm, ref, _pack(*START), n_steps=5)
    assert calls == [12, 2] * 5
    p = _pack(*START)
    losses, norms = [], []
    for _ in range(5):
        g = fd._fd_combine(tf.loss(fd._fd_rows(p, EPS), tm, ref), EPS)
        gn = torch.linalg.norm(g)
        new = p - (0.02 / gn if float(gn) > 1e-12 else 0.0) * g
        l_new, l_cur = tf.loss(torch.stack([new, p]), tm, ref).tolist()
        if l_new < l_cur:
            p = new
        losses.append(min(l_new, l_cur))
        norms.append(float(gn))
    assert torch.equal(params, p)
    np.testing.assert_array_equal(hist["loss"].numpy(),
                                  np.float32(losses))
    np.testing.assert_array_equal(hist["grad_norm"].numpy(),
                                  np.float32(norms))


def test_capture_on_cpu_raises(scene):
    want, tf, tm = scene
    with pytest.raises(ValueError, match="capture=True"):
        tf.fit(tm, torch.tensor(want["ref"]), _pack(*START), n_steps=1,
               capture=True)

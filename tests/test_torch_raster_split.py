"""Port parity: the binned mesh raster under occupancy_split (hi, lo)
against the JAX package's XLA binned path on the CPU.

Both rank the active tiles by descending candidate count; the first
max(1, hi) keep max_faces_per_bin slots and the tail lo, so an undersized
lo drops the same faces in both. hi at or above the active-tile count runs
unsplit. The scene is tests/test_binned_raster.py's split scene cut to
64x64 (16 tiles of 16 pixels): B=2 views of a level-2 icosphere (320
faces), max_faces_per_bin 128.

Tolerances: face ids equal at K=1. At K=4 with blur 1e-3 they differ
only at selection-depth ties (zbuf within 1e-5 there; 48 of 8192 pixels
here, split or not), as tests/test_torch_raster.py allows. zbuf, bary and
dists within 1e-5 where the ids agree (the two packages interpolate in
float32 in another order), the soft silhouette within 1e-4 on pixels
without a tie (the bound of
tests/test_torch_shading.py: sigmoid(-dists / 1e-4) scales float32
rounding of the distances by 1e4). Each package's split route equals its
unsplit one where the split drops nothing, and the port's vertex gradient
its unsplit one within 1e-5 (count-ordered tiles add a face's terms in
another order; tests/test_binned_raster.py's bound). At K=1 that gradient is
within 2e-3 of the largest of JAX's (the port's soft and raster parity
tests' bound: float32 sums in another order). At K=4 with blur 1e-3 the
routes pick other faces at selection-depth ties (zbuf within 4.8e-7 there),
and a tie pixel's gradient goes to another face's vertices: JAX's binned
gradient differs from its own dense one by 2.3% of the largest, and from
the port's by 3.4%. With the tie pixels weighted to zero (every pixel where
any of the four routes, each package split and unsplit, picks other
faces; JAX run op by op, whose picks its gradient then follows: under
jax.jit it picks otherwise on a few pixels more) the port's gradient is
held within 3e-4 of JAX's largest.
"""

import dataclasses
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_renderer_tpu.cameras.perspective import PerspectiveCamera
from torch_renderer_tpu.ops.icosphere import icosphere
from torch_renderer_tpu.rasterize.binning import (
    suggest_active_tiles_fd,
    suggest_occupancy_split_fd,
)
from torch_renderer_tpu.rasterize.geometry import setup_faces
from torch_renderer_tpu.rasterize.raster import (
    RasterizationSettings,
    rasterize_meshes,
)
from torch_renderer_tpu.structures.meshes import Meshes
from torch_renderer_tpu_torch import interop
from torch_renderer_tpu_torch.rasterize import raster

B, IMG, TILE, MFB = 2, 64, 16, 128
FIELDS = ("pix_to_face", "zbuf", "bary", "dists")
GRAD_TOL = 2e-3
TIE_GRAD_TOL = 3e-4   # K=4, blur 1e-3, tie pixels weighted to zero


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module: the suite runs several workers
    on one machine, where torch's default of one thread per core
    oversubscribes it and the fits slow down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    verts, faces = icosphere(2)
    f = 0.8 * IMG
    K = np.array([[f, 0, IMG / 2], [0, f, IMG / 2], [0, 0, 1]], np.float32)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3))
    t = np.array([[0.0, 0.0, 3.5], [0.4, -0.3, 3.0]], np.float32)
    jm = Meshes.from_single(verts, faces).extend(B)
    jc = PerspectiveCamera.from_K(K, (IMG, IMG), R=R, t=t)
    pm = interop.meshes_from_arrays(jm.verts, jm.faces, jm.num_verts,
                                    jm.num_faces, device="cpu")
    pc = interop.camera_from_arrays(jc.fx, jc.fy, jc.cx, jc.cy, jc.R, jc.t,
                                    jc.image_size, device="cpu")
    return jm, jc, pm, pc


def _settings(jm, jc, K_, blur, split="sized"):
    """The JAX settings: active tiles sized for the scene, the split sized
    by suggest_occupancy_split_fd (forced where it sizes none) or given."""
    fd = setup_faces(jm, jc)
    pad = math.sqrt(blur) if blur > 0 else 0.0
    act = suggest_active_tiles_fd(fd, (IMG, IMG), TILE, pad)
    if split == "sized":
        split = suggest_occupancy_split_fd(fd, (IMG, IMG), TILE, pad, act,
                                           MFB) or (max(8, act // 2), 64)
    return RasterizationSettings(
        image_size=(IMG, IMG), faces_per_pixel=K_, blur_radius=blur,
        bin_size=TILE, max_faces_per_bin=MFB, impl="xla", active_tiles=act,
        occupancy_split=split, check_budgets="off")


def _port(st):
    return interop.raster_settings_from_fields(**dataclasses.asdict(st))


def _silhouette(dists, pix_to_face, sigma=1e-4):
    """The soft silhouette of the fragments (both packages' blend)."""
    prob = np.where(pix_to_face >= 0, 0.5 * (1.0 - np.tanh(
        dists / (2.0 * sigma))), 0.0)
    return 1.0 - np.prod(1.0 - prob, axis=-1)


def _assert_same(ours, ref):
    po, pr = ours.pix_to_face.numpy(), np.asarray(ref.pix_to_face)
    zo, zr = ours.zbuf.numpy(), np.asarray(ref.zbuf)
    tie = po != pr
    if po.shape[-1] == 1:
        assert not tie.any()
    np.testing.assert_allclose(zo[tie], zr[tie], rtol=0, atol=1e-5)
    for name in FIELDS[1:]:
        np.testing.assert_allclose(getattr(ours, name).numpy()[~tie],
                                   np.asarray(getattr(ref, name))[~tie],
                                   rtol=0, atol=1e-5, err_msg=name)
    same_px = ~tie.any(-1)
    np.testing.assert_allclose(
        _silhouette(ours.dists.numpy().astype(np.float64), po)[same_px],
        _silhouette(np.asarray(ref.dists, np.float64), pr)[same_px],
        rtol=0, atol=1e-4)


def _render_both(scene, st):
    jm, jc, pm, pc = scene
    return (raster.rasterize_meshes(pm, pc, _port(st)),
            rasterize_meshes(jm, jc, st))


def test_undersized_lo_lanes_drops_as_jax(scene):
    """A tail budget of 2 slots: both packages drop the tail tiles'
    candidates beyond their lowest-id two."""
    jm, jc, _, _ = scene
    st = _settings(jm, jc, 1, 0.0, split=(4, 2))
    ours, ref = _render_both(scene, st)
    _assert_same(ours, ref)
    unsplit, _ = _render_both(scene, dataclasses.replace(
        st, occupancy_split=None))
    dropped = (unsplit.pix_to_face != ours.pix_to_face).sum()
    assert dropped > 50, "the tail budget dropped nothing"
    _assert_grad_matches_jax(scene, st, _port_grad(scene, st))


def test_hi_at_active_count_runs_unsplit(scene):
    """hi >= the active-tile count: the single-budget path, nothing
    demoted to lo_lanes (tests/test_binned_raster.py's fallback case)."""
    jm, jc, _, _ = scene
    base = _settings(jm, jc, 1, 0.0, split=None)
    st = dataclasses.replace(base, occupancy_split=(base.active_tiles, 1))
    ours, ref = _render_both(scene, st)
    _assert_same(ours, ref)
    unsplit, _ = _render_both(scene, base)
    for name in FIELDS:
        assert torch.equal(getattr(ours, name), getattr(unsplit, name))


@pytest.mark.parametrize("K_,blur", [(1, 0.0), (4, 1e-3)])
def test_sized_split_matches_jax(scene, K_, blur):
    """The sized (or forced) split: fragments equal to JAX's and to the
    unsplit route's; vertex gradients within 2e-3 of the largest."""
    jm, jc, pm, pc = scene
    st = _settings(jm, jc, K_, blur)
    ours, ref = _render_both(scene, st)
    _assert_same(ours, ref)
    unsplit, ref_unsplit = _render_both(scene, dataclasses.replace(
        st, occupancy_split=None))
    for name in FIELDS:
        assert torch.equal(getattr(ours, name), getattr(unsplit, name))
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      np.asarray(getattr(ref_unsplit, name)))

    # count-ordered tiles add each face's gradient in another order
    # (tests/test_binned_raster.py's tolerance)
    gp = _port_grad(scene, st)
    np.testing.assert_allclose(
        gp, _port_grad(scene, dataclasses.replace(st, occupancy_split=None)),
        rtol=1e-5, atol=1e-5)
    if K_ == 1:
        _assert_grad_matches_jax(scene, st, gp)
        return
    # K=4: off the ties, against JAX op by op
    frags = [f.pix_to_face.numpy() for f in (ours, unsplit)] + [
        np.asarray(f.pix_to_face) for f in (ref, ref_unsplit)]
    tie = np.zeros(frags[0].shape[:3], bool)
    for f in frags[1:]:
        tie |= (f != frags[0]).any(-1)
    assert 0 < tie.sum() < 0.02 * tie.size, tie.sum()
    keep = (~tie)[..., None].astype(np.float32)
    _assert_grad_matches_jax(scene, st, _port_grad(scene, st, keep),
                             keep=keep, tol=TIE_GRAD_TOL, jit=False)


def _port_grad(scene, st, keep=None):
    _, _, pm, pc = scene
    v = pm.verts.clone().requires_grad_(True)
    fr = raster.rasterize_meshes(pm.update_padded(v), pc, _port(st))
    _loss_terms(fr, torch.where, keep).sum().backward()
    return v.grad.numpy()


def _assert_grad_matches_jax(scene, st, gp, keep=None, tol=GRAD_TOL,
                             jit=True):
    jm, jc, _, _ = scene

    def jloss(v):
        fr = rasterize_meshes(jm.update_padded(v), jc, st)
        return jnp.sum(_loss_terms(fr, jnp.where, keep))

    grad = jax.grad(jloss)
    gj = np.asarray((jax.jit(grad) if jit else grad)(jm.verts))
    assert np.abs(gj).max() > 0
    np.testing.assert_allclose(gp, gj, atol=tol * np.abs(gj).max())


def _loss_terms(fr, where, keep=None):
    """tests/test_torch_raster.py's gradient loss: zbuf, dists and bary of
    the live fragments, weighted by cos(pixel index) and by keep (B, H, W,
    1), where given."""
    w = np.cos(np.arange(IMG * IMG, dtype=np.float32)).reshape(1, IMG, IMG,
                                                                1)
    if keep is not None:
        w = w * keep
    m = fr.pix_to_face >= 0
    val = (where(m, fr.zbuf, 0.0) + where(m, fr.dists, 0.0)
           + where(m[..., None], fr.bary, 0.0).sum(-1))
    return val * (w if where is jnp.where else torch.from_numpy(w))


def test_tail_overflow_warns(scene):
    """tests/test_budget_checks.py's case: a tail budget of 2 under "warn"
    warns with the JAX package's message."""
    jm, jc, pm, pc = scene
    st = dataclasses.replace(_settings(jm, jc, 1, 0.0, split=(1, 2)),
                             check_budgets="warn")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        raster.rasterize_meshes(pm, pc, _port(st))
    msgs = [str(w.message) for w in rec]
    assert any("occupancy_split lo_lanes overflow" in m for m in msgs), msgs

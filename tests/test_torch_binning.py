"""Port parity: active-tile rank binning of torch_renderer_tpu_torch against
the JAX package, on the CPU.

Both packages bin the same face planes (the JAX FacePlanes carried over
through interop.face_planes_from_arrays). Binning is integer bookkeeping
plus exact copies, so every output must be exactly equal, including with
budgets that drop tiles and faces.
"""

import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_renderer_tpu.cameras.perspective import PerspectiveCamera
from torch_renderer_tpu.ops.icosphere import icosphere
from torch_renderer_tpu.rasterize import binning as jb
from torch_renderer_tpu.rasterize.geometry import setup_face_planes
from torch_renderer_tpu.structures.meshes import Meshes
from torch_renderer_tpu_torch.interop import face_planes_from_arrays
from torch_renderer_tpu_torch.rasterize import binning as pb

IMG = 32
B = 2
PAD = math.sqrt(16.0 * 1e-4)   # sqrt(SOFT_CUTOFF * sigma) at sigma = 1e-4
BIN_FIELDS = ("slot", "count", "invrank", "rank", "origin", "n_active")


@pytest.fixture(scope="module")
def planes():
    """(JAX FacePlanes, port FacePlanes) of the packed-soft test scene."""
    verts, faces = icosphere(1)
    meshes = Meshes.from_single(verts, faces).extend(B)
    f = 0.8 * IMG
    K = np.array([[f, 0, IMG / 2], [0, f, IMG / 2], [0, 0, 1]], np.float32)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3))
    t = np.array([[0.0, 0.0, 3.0], [0.15, -0.1, 2.6]], np.float32)
    jfp = setup_face_planes(meshes, PerspectiveCamera.from_K(
        K, (IMG, IMG), R=R, t=t))
    return jfp, face_planes_from_arrays(*map(np.asarray, jfp))


def test_tile_grid_matches_jax():
    for size, tile in (((32, 32), 16), ((48, 96), 16), ((30, 20), 8)):
        jTH, jTW, jo = jb.tile_grid(size, tile)
        pTH, pTW, po = pb.tile_grid(size, tile)
        assert (pTH, pTW) == (jTH, jTW)
        np.testing.assert_array_equal(po.numpy(), np.asarray(jo))


# (tile, active_tiles): 16/4 keeps all 4 tiles; 8/4 keeps 4 of the ~12
# non-empty tiles of 16 (tiles beyond the budget are dropped); 8/64 is a
# budget above the tile count (clamped to T, unused slots scatter nowhere).
@pytest.mark.parametrize("tile,active", [(16, 4), (8, 4), (8, 64)])
def test_bin_faces_active_matches_jax(planes, tile, active):
    jfp, pfp = planes
    jbins = jb.bin_faces_active(jfp, (IMG, IMG), tile, PAD, active)
    pbins = pb.bin_faces_active(pfp, (IMG, IMG), tile, PAD, active)
    for name in BIN_FIELDS:
        np.testing.assert_array_equal(getattr(pbins, name).numpy(),
                                      np.asarray(getattr(jbins, name)),
                                      err_msg=name)
    assert pbins.n_tiles_hw == jbins.n_tiles_hw
    if tile == 8 and active == 4:
        assert int(pbins.n_active.min()) > active   # the budget drops tiles


@pytest.mark.parametrize("per_tile", [80, 8])
def test_slot_faces_match_jax_gather(planes, per_tile):
    """The port's slot table, used as a gather, gives the JAX rank gather's
    corner channels on every live slot; per_tile=8 drops faces."""
    jfp, pfp = planes
    jbins = jb.bin_faces_active(jfp, (IMG, IMG), 8, PAD, 16)
    pbins = pb.bin_faces_active(pfp, (IMG, IMG), 8, PAD, 16)
    names = ("qx0", "qy0", "qx1", "qy1", "qx2", "qy2")
    ch, mask = jb.gather_rank_planes(jfp, jbins, per_tile, channels=names)
    table = pb.slot_faces(pbins, per_tile)
    live = (torch.arange(per_tile) < pbins.count[..., None].clamp(
        max=per_tile))
    np.testing.assert_array_equal(live.numpy(), np.asarray(mask))
    if per_tile == 8:
        assert int(pbins.count.max()) > per_tile    # the budget drops faces
    src = dict(zip(names, (pfp.x0, pfp.y0, pfp.x1, pfp.y1, pfp.x2, pfp.y2)))
    for name in names:
        got = torch.gather(src[name], 1, table.reshape(B, -1)).reshape(
            table.shape)
        np.testing.assert_array_equal(
            torch.where(live, got, 0.0).numpy(),
            np.where(np.asarray(mask), np.asarray(ch[name]), 0.0),
            err_msg=name)


def test_scatter_active_and_untile_match_jax(planes):
    jfp, pfp = planes
    jbins = jb.bin_faces_active(jfp, (IMG, IMG), 8, PAD, 4)
    pbins = pb.bin_faces_active(pfp, (IMG, IMG), 8, PAD, 4)
    vals = np.random.default_rng(0).normal(size=(B, 4, 64)).astype(np.float32)
    jfull = jb.scatter_active(jnp.asarray(vals), jbins)
    pfull = pb.scatter_active(torch.from_numpy(vals), pbins)
    np.testing.assert_array_equal(pfull.numpy(), np.asarray(jfull))
    jimg = jb.untile_image(jfull, (IMG, IMG), 8, jbins.n_tiles_hw)
    pimg = pb.untile_image(pfull, (IMG, IMG), 8, pbins.n_tiles_hw)
    assert tuple(pimg.shape) == (B, IMG, IMG)
    np.testing.assert_array_equal(pimg.numpy(), np.asarray(jimg))
    # cropping a padded grid, with a trailing channel axis
    per_tile = np.arange(B * 6 * 64 * 2, dtype=np.float32).reshape(B, 6, 64, 2)
    np.testing.assert_array_equal(
        pb.untile_image(torch.from_numpy(per_tile), (20, 22), 8, (3, 2)).numpy(),
        np.asarray(jb.untile_image(jnp.asarray(per_tile), (20, 22), 8, (3, 2))))


def test_sizing_helpers_match_jax(planes):
    jfp, pfp = planes
    for tile in (8, 16):
        jm, jn = jb.count_overflow(jfp, (IMG, IMG), tile, 20, PAD)
        pm, pn = pb.count_overflow(pfp, (IMG, IMG), tile, 20, PAD)
        assert (int(pm), int(pn)) == (int(jm), int(jn))
        assert int(pb.count_active_tiles(pfp, (IMG, IMG), tile, PAD)) == \
            int(jb.count_active_tiles(jfp, (IMG, IMG), tile, PAD))
        assert pb.suggest_active_tiles_fd(pfp, (IMG, IMG), tile, PAD) == \
            jb.suggest_active_tiles_fd(jfp, (IMG, IMG), tile, PAD)
        for act, fpt in ((4, 80), (9, 16)):
            assert pb.suggest_group_lanes_fd(
                pfp, (IMG, IMG), tile, PAD, act, fpt) == \
                jb.suggest_group_lanes_fd(jfp, (IMG, IMG), tile, PAD, act, fpt)


def test_check_budget_modes():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pb.check_budget("x", torch.tensor(9), 4, None)      # no-op
        pb.check_budget("x", torch.tensor(9), 4, "off")
        pb.check_budget("x", torch.tensor(3), 4, "warn")    # within budget
    with pytest.warns(RuntimeWarning, match="x overflow: max count 9"):
        pb.check_budget("x", torch.tensor(9), 4, "warn", hint="size it")
    with pytest.raises(ValueError, match="unknown budget check mode"):
        pb.check_budget("x", 9, 4, "bogus")
    with pytest.raises(ValueError, match="unknown budget check mode"):
        pb.set_budget_check_default("bogus")
    try:
        pb.set_budget_check_default("warn")
        with pytest.warns(RuntimeWarning):
            pb.check_budget("x", 9, 4, None)                # the default
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            pb.check_budget("x", 9, 4, "off")               # explicit wins
    finally:
        pb.set_budget_check_default(None)

"""Port parity: the untile kernel module (rasterize/cuda_untile.py) against
the JAX package's fused scatter + untile (rasterize/pallas_untile.py, run in
interpret mode) and its XLA epilogue (scatter + binning.untile_image), on
the CPU, where the port's wrapper runs its plain PyTorch version; and the
port's binned raster, which ends with the wrapper, against its plain
epilogue.

The counterpart of tests/test_pallas_untile.py. Tolerances: values are
copies, so bit-exact; gradients within 1e-5 (that file's bound).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_renderer_tpu_torch as port
from torch_renderer_tpu.rasterize.binning import untile_image
from torch_renderer_tpu.rasterize.pallas_untile import (
    tile_slot_table,
    untile_scatter_pallas,
)
from torch_renderer_tpu_torch.rasterize import cuda_hard, cuda_untile
from torch_renderer_tpu_torch.rasterize.binning import scatter_active_bg
from torch_renderer_tpu_torch.rasterize.binning import (
    untile_image as untile_image_port,
)

B, TH, TW, A = 2, 3, 5, 9
NTHW = (TH, TW)


def _compacted(tile, C=1, seed=0, dtype=np.float32):
    """tests/test_pallas_untile.py's compacted case: A of the T tiles hold
    a row, the rest none."""
    rng = np.random.default_rng(seed)
    T = TH * TW
    rank = np.full((B, T), 10 ** 6, np.int32)
    for b in range(B):
        rank[b, rng.choice(T, A, replace=False)] = np.arange(A)
    rows = rng.standard_normal((B, A, tile * tile, C)).astype(dtype)
    return rows, rank


def _scatter_ref(rows, rank, bg):
    full = np.full((B, TH * TW) + rows.shape[2:], bg, rows.dtype)
    for b in range(B):
        for t in range(TH * TW):
            if rank[b, t] < A:
                full[b, t] = rows[b, rank[b, t]]
    return full


def _port(rows, rank, bg, size, tile, A_=A):
    table = cuda_untile.tile_slot_table(torch.from_numpy(rank).long(), A_,
                                        NTHW)
    return port.untile_scatter(torch.from_numpy(rows), table, bg, size,
                               tile, NTHW)


@pytest.mark.parametrize("tile", [16, 32])
def test_fwd_bit_exact_compacted_cropped(tile):
    rows, rank = _compacted(tile)
    H, W = TH * tile - 5, TW * tile - 3                  # exercise the crop
    img = _port(rows, rank, -1.0, (H, W), tile).numpy()
    assert img.shape == (B, H, W, 1)
    want = np.asarray(untile_scatter_pallas(
        jnp.asarray(rows), tile_slot_table(jnp.asarray(rank), A, NTHW), -1.0,
        (H, W), tile, NTHW))
    np.testing.assert_array_equal(img, want)
    xla = np.asarray(untile_image(jnp.asarray(_scatter_ref(rows, rank, -1.0)),
                                  (H, W), tile, NTHW))
    np.testing.assert_array_equal(img, xla)


def test_fwd_identity_multichannel():
    tile, T = 16, TH * TW
    rows = np.random.default_rng(1).standard_normal(
        (B, T, tile * tile, 3)).astype(np.float32)
    H, W = TH * tile, TW * tile
    table = cuda_untile.tile_slot_table(None, T, NTHW, batch=B)
    jtable = tile_slot_table(None, T, NTHW, batch=B)
    np.testing.assert_array_equal(table.numpy(),
                                  np.asarray(jtable)[:, :T].astype(np.int32))
    img = port.untile_scatter(torch.from_numpy(rows), table, 0.0, (H, W),
                              tile, NTHW)
    want = np.asarray(untile_scatter_pallas(jnp.asarray(rows), jtable, 0.0,
                                            (H, W), tile, NTHW))
    np.testing.assert_array_equal(img.numpy(), want)
    np.testing.assert_array_equal(img.numpy(), np.asarray(untile_image(
        jnp.asarray(rows), (H, W), tile, NTHW)))


def test_int64_field_with_bg():
    """An int64 id field (pix_to_face) goes through unchanged, ids beyond
    float32's exact range included, with background -1."""
    tile = 16
    rows, rank = _compacted(tile, C=2, seed=2)
    ids = (np.abs(rows) * 1e6).astype(np.int64) + (1 << 40)
    H, W = TH * tile - 2, TW * tile - 9
    img = _port(ids, rank, -1, (H, W), tile)
    assert img.dtype == torch.int64
    want = _scatter_ref(ids, rank, -1).reshape(B, TH, TW, tile, tile, 2)
    want = want.transpose(0, 1, 3, 2, 4, 5).reshape(
        B, TH * tile, TW * tile, 2)[:, :H, :W]
    np.testing.assert_array_equal(img.numpy(), want)
    # small ids agree with the JAX XLA epilogue on int32
    small = (ids - (1 << 40)).astype(np.int32)
    np.testing.assert_array_equal(
        _port(small, rank, -1, (H, W), tile).numpy(),
        np.asarray(untile_image(jnp.asarray(_scatter_ref(small, rank, -1)),
                                (H, W), tile, NTHW)))


def test_tile_slot_table_matches_jax():
    _, rank = _compacted(16)
    got = cuda_untile.tile_slot_table(torch.from_numpy(rank).long(), A, NTHW)
    want = np.asarray(tile_slot_table(jnp.asarray(rank), A, NTHW))
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, TH * TW)
    np.testing.assert_array_equal(got.numpy(),
                                  want[:, :TH * TW].astype(np.int32))


@pytest.mark.parametrize("C", [1, 3])
def test_gradients_match_jax(C):
    tile = 16
    rows, rank = _compacted(tile, C=C, seed=3)
    H, W = TH * tile - 5, TW * tile - 3
    jtable = tile_slot_table(jnp.asarray(rank), A, NTHW)
    g_j = np.asarray(jax.grad(lambda r: jnp.sum(untile_scatter_pallas(
        r, jtable, -1.0, (H, W), tile, NTHW) ** 3))(jnp.asarray(rows)))
    r = torch.from_numpy(rows).requires_grad_(True)
    table = cuda_untile.tile_slot_table(torch.from_numpy(rank).long(), A,
                                        NTHW)
    (port.untile_scatter(r, table, -1.0, (H, W), tile, NTHW) ** 3).sum(
    ).backward()
    np.testing.assert_allclose(r.grad.numpy(), g_j, rtol=0, atol=1e-5)
    assert np.abs(g_j).max() > 0


def test_wrapper_rejects_bad_inputs():
    rows = torch.zeros((B, A, 256, 1))
    table = torch.zeros((B, TH * TW), dtype=torch.int32)
    with pytest.raises(ValueError, match="tileof"):
        port.untile_scatter(rows, table.long(), 0.0, (40, 70), 16, NTHW)
    with pytest.raises(ValueError, match="rows"):
        port.untile_scatter(rows[:, :, :100], table, 0.0, (40, 70), 16, NTHW)
    with pytest.raises(ValueError, match="grid"):
        port.untile_scatter(rows, table, 0.0, (60, 70), 16, NTHW)


# ---------------------------------------------------------------------------
# The raster's epilogue: the untile kernel's wrapper against the plain one
# ---------------------------------------------------------------------------

def _scene(level, views):
    verts, faces = port.icosphere(level)
    m = port.Meshes.from_single(verts, faces, device="cpu").extend(len(views))
    R, t = port.look_at_view_transform(
        2.7, [v[0] for v in views], [v[1] for v in views])
    return m, R, t


def _plain_epilogue(monkeypatch):
    """End the binned raster with the plain version, differentiated by
    autograd, in place of the untile wrapper and its own backward."""
    monkeypatch.setattr(cuda_hard, "untile_scatter",
                        cuda_untile.untile_scatter_reference)


@pytest.mark.parametrize("act", [None, 24])
def test_depth_render_parity(monkeypatch, act):
    """DepthRender depth and silhouette are bit-identical through the untile
    wrapper and the plain epilogue, with and without active-tile compaction
    (24 tiles drops some non-empty ones, so empty and dropped tiles both
    take the background), and each field equals the scatter + untile of the
    tile fields; untile_impl changes nothing."""
    H, W = 96, 128
    f = 0.9 * H
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    m, R, t = _scene(3, [(15.0, 0.0), (40.0, 120.0), (65.0, 240.0)])
    kw = dict(bin_size=16, max_faces_per_bin=128, active_tiles=act,
              device="cpu")
    a = port.DepthRender(K, (H, W), **kw)
    b = port.DepthRender(K, (H, W), untile_impl="pallas", **kw)
    launches = cuda_untile.UNTILE_LAUNCHES
    da, sa = a.render(m, R, t, return_silhouette=True)
    db, sb = b.render(m, R, t, return_silhouette=True)
    assert cuda_untile.UNTILE_LAUNCHES == launches   # the CPU runs no kernel
    assert tuple(da.shape) == (3, H, W)
    assert float((da > 0).float().mean()) > 0.1
    assert torch.equal(da, db) and torch.equal(sa, sb)
    fd = port.setup_faces(m, a.camera_with_pose(R, t))
    frags = cuda_hard.rasterize_binned_cuda(fd, a.settings)
    bins, fields = cuda_hard.binned_tile_fields(fd, a.settings)
    for name, (v, bg) in fields.items():
        want = untile_image_port(scatter_active_bg(v, bins, bg), (H, W), 16,
                                 bins.n_tiles_hw)
        assert torch.equal(getattr(frags, name), want), name
    _plain_epilogue(monkeypatch)
    dp, sp = a.render(m, R, t, return_silhouette=True)
    assert torch.equal(da, dp) and torch.equal(sa, sp)


def test_k4_fragments_and_grad_parity(monkeypatch):
    """K>1 fragments (bary rides as C = K * 3 channels) and the soft
    silhouette's vertex gradient through the untile wrapper's backward,
    against the plain epilogue differentiated by autograd."""
    H = W = 96
    f = 0.8 * H
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    verts, faces = port.icosphere(2)
    m = port.Meshes.from_single(verts, faces, device="cpu")
    R, t = port.look_at_view_transform(3.0, 25.0, 40.0)
    blur = 1e-4 * math.log(1 / 1e-4 - 1)
    r = port.MeshRenderer(K, (H, W), blur_radius=blur, faces_per_pixel=4,
                          bin_size=16, max_faces_per_bin=128, device="cpu")

    def run():
        v = m.verts.clone().requires_grad_(True)
        out = r.render(m.update_padded(v), R, t)
        (g,) = torch.autograd.grad((out.silhouette ** 2).sum(), v)
        return out.fragments, g

    fa, g_a = run()
    _plain_epilogue(monkeypatch)
    fb, g_b = run()
    for name in ("pix_to_face", "zbuf", "bary", "dists"):
        assert torch.equal(getattr(fa, name), getattr(fb, name)), name
    assert int((fa.pix_to_face[..., 1] >= 0).sum()) > 100
    assert bool(torch.isfinite(g_a).all()) and float(g_b.abs().max()) > 0
    torch.testing.assert_close(g_a, g_b, rtol=0, atol=1e-5)

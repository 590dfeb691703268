"""Port parity: the tile-gather kernel module (rasterize/cuda_gather.py)
against the JAX package's Pallas gather (rasterize/pallas_gather.py, run in
interpret mode), on the CPU, where the port's wrappers run their plain
PyTorch versions; and the binned paths' slabs, which now load through it.

Tolerances, from tests/test_pallas_gather.py: values within 1e-6 (the JAX
kernel is a one-hot matmul in float32, the port a copy), table gradients
within 1e-5 (sums of the same terms in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_renderer_tpu_torch as port
from torch_renderer_tpu.ops.icosphere import icosphere
from torch_renderer_tpu.rasterize.pallas_gather import gather_tiles
from torch_renderer_tpu_torch.rasterize import binning, cuda_gather, cuda_soft
from torch_renderer_tpu_torch.rasterize.geometry import setup_face_planes


def _case(B=2, T=24, Fmax=16, F=200, C=12, seed=0):
    """tests/test_pallas_gather.py's inputs: a valid prefix of ascending
    distinct ids per tile, -1 after it."""
    rng = np.random.RandomState(seed)
    idx = np.full((B, T, Fmax), -1, np.int32)
    for b in range(B):
        for t in range(T):
            n = rng.randint(0, Fmax + 1)
            idx[b, t, :n] = np.sort(rng.choice(F, size=n, replace=False))
    table = rng.randn(B, F, C).astype(np.float32)
    return idx, table


CASES = {
    "default": dict(),
    "odd_sizes": dict(B=1, T=5, Fmax=8, F=130, C=3, seed=1),
    "multi_chunk_faces": dict(B=1, T=8, Fmax=8, F=2300, C=2, seed=3),
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_gather_matches_jax(name, dtype):
    idx, table = _case(**CASES[name])
    want = np.asarray(gather_tiles(jnp.asarray(idx), jnp.asarray(table)))
    got = port.gather_tiles(torch.tensor(idx, dtype=dtype),
                            torch.from_numpy(table))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert bool((got[torch.from_numpy(idx) < 0] == 0).all())


def test_gather_grad_matches_jax():
    idx, table = _case(B=2, T=8, Fmax=8, F=96, C=4, seed=2)
    w = np.cos(np.arange(2 * 8 * 8 * 4, dtype=np.float32)).reshape(2, 8, 8, 4)
    g_j = np.asarray(jax.grad(
        lambda t: jnp.sum(gather_tiles(jnp.asarray(idx), t) * w))(
            jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_(True)
    (port.gather_tiles(torch.from_numpy(idx), t) * torch.from_numpy(w)).sum(
    ).backward()
    np.testing.assert_allclose(t.grad.numpy(), g_j, rtol=0, atol=1e-5)
    assert np.linalg.norm(g_j) > 0
    # the backward's plain version directly, int64 ids
    dt = cuda_gather.gather_tiles_bwd_reference(
        torch.from_numpy(idx).long(), torch.from_numpy(w), 96)
    np.testing.assert_allclose(dt.numpy(), g_j, rtol=0, atol=1e-5)


def test_out_of_range_ids_are_empty():
    """Ids at or beyond F read nothing, as the JAX one-hot reads nothing."""
    idx = torch.tensor([[[0, 3, 4, -1, 7]]], dtype=torch.int32)
    table = torch.arange(8, dtype=torch.float32).reshape(1, 4, 2)
    out = port.gather_tiles(idx, table)
    assert out[0, 0, :, 0].tolist() == [0.0, 6.0, 0.0, 0.0, 0.0]
    want = np.asarray(gather_tiles(jnp.asarray(idx.numpy()),
                                   jnp.asarray(table.numpy())))
    np.testing.assert_array_equal(out.numpy(), want)


def test_wrapper_rejects_bad_inputs():
    table = torch.zeros((1, 4, 2))
    with pytest.raises(ValueError, match="idx"):
        port.gather_tiles(torch.zeros((1, 2, 3)), table)
    with pytest.raises(ValueError, match="table"):
        port.gather_tiles(torch.zeros((1, 2, 3), dtype=torch.int32),
                          table.double())


@pytest.fixture(scope="module")
def planes():
    """Port FacePlanes of a two-view icosphere(2) scene at 48x64, and its
    active-tile bins at tile 8 with a budget that drops faces."""
    verts, faces = icosphere(2)
    m = port.Meshes.from_single(verts, faces, device="cpu").extend(2)
    K = np.array([[40.0, 0, 32], [0, 40.0, 24], [0, 0, 1]], np.float32)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (2, 3, 3))
    t = np.array([[0.0, 0.0, 3.0], [0.2, -0.1, 2.5]], np.float32)
    cam = port.PerspectiveCamera.from_K(K, (48, 64), R=R, t=t, device="cpu")
    fp = setup_face_planes(m, cam)
    return fp, binning.bin_faces_active(fp, (48, 64), 8, 0.02, 30)


def _previous_gather(ch, table):
    """The slab gather before the kernel: every slot's row by the table
    clamped to face 0 at dead slots."""
    B, A, K = table.shape
    C = ch.shape[2]
    return ch.gather(1, table.clamp_min(0).reshape(B, A * K, 1).expand(
        B, A * K, C)).reshape(B, A, K, C)


@pytest.mark.parametrize("per_tile", [64, 6])
def test_tile_channel_slabs_live_and_dead(planes, per_tile):
    fp, bins = planes
    ch12 = binning.face_channel_planes(fp)
    slab, count, table = binning.tile_channel_slabs(ch12, bins, per_tile)
    assert slab.shape == (2, 30, per_tile, 13)
    N = ch12.shape[1]
    fid = torch.arange(N, dtype=torch.float32).expand(2, N)[..., None]
    prev = _previous_gather(torch.cat([ch12, fid], -1), table)
    live = torch.arange(per_tile) < count[..., None]
    assert int(live.sum()) > 100
    if per_tile == 6:
        assert int(bins.count.max()) > per_tile      # the budget drops faces
    assert torch.equal(slab[live], prev[live])
    assert bool((slab[~live] == 0).all())
    assert table.is_contiguous()                     # as the kernel takes it
    assert bool((table[~live] == -1).all())          # dead slots marked
    assert bool((table[live] >= 0).all())


def test_soft_tile_slabs_live_and_dead(planes):
    fp, bins = planes
    per_tile = 40
    q, count = cuda_soft.tile_slabs(fp, bins, per_tile)
    table = binning.slot_faces(bins, per_tile)
    corners = torch.stack([fp.x0, fp.y0, fp.x1, fp.y1, fp.x2, fp.y2], -1)
    shift = bins.origin.repeat(1, 1, 3)[:, :, None, :]
    prev = _previous_gather(corners, table) - shift
    live = torch.arange(per_tile) < count[..., None]
    assert torch.equal(q[live], prev[live])
    assert torch.equal(q[~live], (-shift).expand_as(q)[~live])
    # the gradient of a slab loss reaches only the live slots' faces
    x = corners.detach().requires_grad_(True)
    fp2 = fp._replace(**{n: x[..., i] for i, n in enumerate(
        ("x0", "y0", "x1", "y1", "x2", "y2"))})
    q2, _ = cuda_soft.tile_slabs(fp2, bins, per_tile)
    q2.sum().backward()
    rows = torch.arange(2)[:, None, None].expand_as(table)
    want = torch.zeros(corners.shape[:2]).index_put_(
        (rows[live], table[live]), torch.ones(()), accumulate=True)
    np.testing.assert_array_equal(x.grad.numpy(),
                                  want[..., None].expand_as(x).numpy())

"""A CPU model of the soft-coverage forward kernel (csrc/soft_coverage.cu
``soft_coverage_fwd_kernel``) against its plain version.

The kernel sums softplus(x), x = -(signed d2) / sigma, over a tile's
candidates, each of its slot groups over its own slots in slot order and
then the groups' sums in group order, with every float32 operation
written out as an ``_rn`` intrinsic, so the model here repeats them (an
FMA as one rounding of the float64 product plus the addend). It skips two
kinds of pairs:

* a (warp, face) pair where the warp's pixel box misses the face's cull box
  (the face's bounding box grown by a margin argued in the source), and
* a (pixel, face) pair whose x lies below the cutoff -104, where exp(x) <
  2^-150 and the plain term is exactly +0.0.

The tests check the claim behind both: every pair the model skips has a
plain term of exactly +0.0 (so the sum is unchanged, bit for bit), on the
soft bench slab, the pose fit's slab and seeded random slabs; and the
model's S equals ``soft_coverage_fwd_reference`` within the card's
tolerance 1e-4 + 1e-5 * max|S|. The softplus itself (``softplus_term``) is
swept over float32 x in [-128, 128] against the float64 softplus: at most
4 ulp where the result is a normal float, within one subnormal step where
it is subnormal, and exactly +0.0 below the cutoff. The constants are read
from the kernel's source, so the model cannot drift from it. No JAX here.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_renderer_tpu_torch.rasterize import cuda_soft

SOURCE = (Path(cuda_soft.__file__).resolve().parents[1] / "csrc"
          / "soft_coverage.cu").read_text()


def _const(name: str) -> np.float32:
    """A float constant of the kernel's source."""
    m = re.search(rf"constexpr float {name} = ([-+0-9.eE]+)f;", SOURCE)
    return np.float32(float(m.group(1)))


LOG2E, ROUND = _const("kLog2e"), _const("kRound")
LN2_HI, LN2_LO = _const("kLn2Hi"), _const("kLn2Lo")
EXP_R = [_const(f"kExpR{k}") for k in range(5)]
LOG1P_Q = [_const(f"kLog1pQ{k}") for k in range(8)]
CUTOFF = _const("kCutoff")
MAX_GROUPS = int(re.search(r"constexpr int kFwdMaxGroups = (\d+);",
                           SOURCE).group(1))
EPS = 2.0 ** -24


def _f(x):
    return torch.as_tensor(x, dtype=torch.float32)


def fma(a, b, c):
    """fmaf: the exact product plus the addend, rounded once (through
    float64, whose 53 bits hold a float32 product exactly)."""
    return (_f(a).double() * _f(b).double() + _f(c).double()).float()


def softplus_term(x: torch.Tensor) -> torch.Tensor:
    """The kernel's softplus_term, operation for operation, for x >=
    CUTOFF (the kernel adds nothing below it: see softplus_model)."""
    x = _f(x)
    y = torch.maximum(-x.abs(), _f(CUTOFF))
    t = fma(y, LOG2E, ROUND)
    j = t - _f(ROUND)
    r = fma(j, -LN2_HI, y)
    r = fma(j, -LN2_LO, r)
    h = torch.full_like(r, float(EXP_R[4]))
    for k in (3, 2, 1, 0):
        h = fma(h, r, EXP_R[k])
    h = fma(h, r, 1.0)
    er = fma(h, r, 1.0)
    bits = t.view(torch.int32) - _f(ROUND).view(torch.int32) + 191
    scale = (bits << 23).view(torch.float32)
    e = (er * scale) * _f(2.0 ** -64)
    q = torch.full_like(e, float(LOG1P_Q[7]))
    for k in range(6, -1, -1):
        q = fma(q, e, LOG1P_Q[k])
    l_ = fma(q * e, e, e)
    return x.clamp_min(0.0) + l_


def softplus_model(x: torch.Tensor) -> torch.Tensor:
    """What a pair adds: softplus_term, or nothing (+0.0) below CUTOFF."""
    return torch.where(x < _f(CUTOFF), _f(0.0), softplus_term(x))


# ---------------------------------------------------------------------------
# (a) the softplus against float64
# ---------------------------------------------------------------------------

def _sweep_x() -> torch.Tensor:
    """float32 x in [-128, 128]: every 509th bit pattern of each sign, and
    every float32 within 2^12 steps of 0, +-1e-7, -104, -87.3 (where the
    result turns subnormal) and +-1."""
    pos = np.arange(0, 0x43000001, 509, dtype=np.int64).astype(np.uint32)
    xs = [pos.view(np.float32), -pos.view(np.float32)]
    for c in (0.0, 1e-7, -1e-7, -104.0, -87.3, 1.0, -1.0):
        b = np.array([c], np.float32).view(np.int32)[0]
        near = (b + np.arange(-4096, 4097)).astype(np.int32).view(np.float32)
        xs.append(near[np.isfinite(near)])
    return torch.from_numpy(np.concatenate(xs).astype(np.float32))


def test_softplus_error_bound():
    x = _sweep_x()
    got = softplus_model(x).double()
    xd = x.double()
    want = xd.clamp_min(0.0) + torch.log1p(torch.exp(-xd.abs()))
    normal = want >= 2.0 ** -126
    ulp = torch.from_numpy(np.spacing(want.float().numpy()).astype(
        np.float64))
    err_ulp = ((got - want).abs() / ulp)[normal]
    err_sub = ((got - want).abs() / 2.0 ** -149)[~normal]
    assert float(err_ulp.max()) <= 4.0, (float(err_ulp.max()),
                                         float(x[normal][err_ulp.argmax()]))
    assert float(err_sub.max()) <= 1.0
    below = x < -104.0
    assert bool(below.any())
    zero = softplus_model(x[below])
    assert bool((zero == 0).all()) and not bool(torch.signbit(zero).any())


def test_cutoff_terms_are_zero_in_the_plain_form():
    """Below the cutoff the plain version's term (torch's softplus form on
    float32) is exactly +0.0 too, down to the most negative x."""
    x = _sweep_x()
    x = x[x < -104.0]
    plain = x.clamp_min(0.0) + torch.log1p(torch.exp(-x.abs()))
    assert bool((plain == 0).all()) and not bool(torch.signbit(plain).any())


# ---------------------------------------------------------------------------
# (b) the kernel's cull and skip on slabs
# ---------------------------------------------------------------------------

def stage_model(q: torch.Tensor, inv_sigma: float):
    """stage_face on every slot: per-edge constants (B, A, K, 3) each and
    the cull boxes (B, A, K, 4) = x0, x1, y0, y1."""
    x, y = q[..., 0::2], q[..., 1::2]                      # (B, A, K, 3)
    area2 = ((x[..., 1] - x[..., 0]) * (y[..., 2] - y[..., 0])
             - (y[..., 1] - y[..., 0]) * (x[..., 2] - x[..., 0]))
    s = torch.where(area2 > 0, 2.0, torch.where(area2 < 0, -2.0, 0.0))
    nxt = [1, 2, 0]
    gx, gy = x[..., nxt] - x, y[..., nxt] - y
    len2 = (gx * gx + gy * gy).clamp_min(1e-12)
    edges = dict(ax=x, ay=y, g2x=2.0 * gx, g2y=2.0 * gy, h=0.5 / len2,
                 len2=len2, sgx=s[..., None] * gx, sgy=s[..., None] * gy)
    r_cut = np.float32(math.sqrt(104.5 / float(np.float32(inv_sigma))))
    L2 = len2.amax(-1)
    L = torch.sqrt(L2)
    area = area2.abs()
    C = torch.maximum(x.abs().amax(-1), y.abs().amax(-1))
    M = (1.001 * (r_cut * 1.002 + 4e-3 * L + 40.0 * EPS * L * L2 / area)
         + 4.0 * EPS * C)
    ok = (area > 4e-12) & (area >= 64.0 * EPS * L2)
    M = torch.where(ok, M, torch.full_like(M, math.inf))
    box = torch.stack([x.amin(-1) - M, x.amax(-1) + M,
                       y.amin(-1) - M, y.amax(-1) + M], dim=-1)
    return edges, box


def pair_x_model(e: dict, px, py, inv_sigma: float):
    """pair_x: x (..., P, K) for pixel coordinates px, py (P, 1) against
    staged edges (..., 1, K, 3) each."""
    d2, inside = None, None
    for k in range(3):
        g = {n: v[..., k] for n, v in e.items()}
        wx, wy = px - g["ax"], py - g["ay"]
        ww = fma(wx, wx, wy * wy)
        wg2 = fma(wx, g["g2x"], wy * g["g2y"])
        t = (wg2 * g["h"]).nan_to_num(0.0).clamp(0.0, 1.0)
        dd = fma(t, fma(t, g["len2"], -wg2), ww)
        ins = fma(g["sgx"], wy, -(g["sgy"] * wx)) >= 0.0
        d2 = dd if d2 is None else torch.minimum(d2, dd)
        inside = ins if inside is None else inside & ins
    k = torch.where(inside, _f(inv_sigma), _f(-inv_sigma))
    return d2.clamp_min(0.0) * k


def fwd_groups(tile: int, tiles: int, sms: int) -> int:
    """The kernel's slot groups per tile (fwd_groups): the most, up to
    kFwdMaxGroups, whose tile^2 threads each fit a 1024-thread block and
    whose warps over `tiles` blocks stay within two waves of 64 warps on
    each of `sms` SMs; one where tile is not a multiple of 8."""
    if tile % 8:
        return 1
    G, warps = 1, tile * tile // 32
    while (2 * G <= MAX_GROUPS and 2 * G * tile * tile <= 1024
           and tiles * 2 * G * warps <= 2 * 64 * sms):
        G *= 2
    return G


def fwd_pixels(tile: int):
    """Each pixel's (row-major index) warp box in pixel units, as the
    kernel maps a group's threads to pixels (fwd_pixel): (P, 4) = c0, c1,
    r0, r1."""
    tp = tile * tile
    box = torch.empty((tp, 4), dtype=torch.int64)
    if tile % 8 == 0:
        for p in range(tp):
            r, c = divmod(p, tile)
            c0, r0 = c // 8 * 8, r // 4 * 4
            box[p] = torch.tensor([c0, c0 + 7, r0, r0 + 3])
        return box
    for p in range(tp):
        lo, hi = p // 32 * 32, min(p // 32 * 32 + 31, tp - 1)
        if lo // tile == hi // tile:
            box[p] = torch.tensor([lo % tile, hi % tile, lo // tile,
                                   hi // tile])
        else:
            box[p] = torch.tensor([0, tile - 1, lo // tile, hi // tile])
    return box


def fwd_model(q, count, tile: int, inv_s: float, inv_sigma: float,
              sms: int = 132):
    """S (B, A, tile^2) through the kernel's arithmetic, cull, skip and
    summation order (each slot group's slots in order, then the groups'
    sums in group order), and the counts of (pixel, live slot) pairs culled
    and skipped. Raises if a culled or skipped pair's plain term is not
    exactly +0.0. sms: the card's SM count, which sets the groups."""
    B, A, K, _ = q.shape
    G = fwd_groups(tile, B * A, sms)
    tp = tile * tile
    inv_s, inv_sigma = float(np.float32(inv_s)), float(np.float32(inv_sigma))
    pix = torch.arange(tp)
    px = ((pix % tile).float() * _f(inv_s))[:, None]
    py = ((pix // tile).float() * _f(inv_s))[:, None]
    wb = fwd_pixels(tile).float() * _f(inv_s)                  # (P, 4)
    S = torch.zeros((B, A, tp))
    culled = skipped = 0
    plain_x, *_ = cuda_soft._pair_terms(q, count, tile, inv_s)
    for a in range(A):
        qa, ca = q[:, a:a + 1], count[:, a:a + 1]
        edges, box = stage_model(qa, inv_sigma)
        e1 = {n: v[:, :, None] for n, v in edges.items()}   # (B,1,1,K,3)
        x = pair_x_model(e1, px, py, inv_sigma)             # (B, 1, P, K)
        bx = box[:, :, None]                                 # (B, 1, 1, K, 4)
        cull = ((wb[:, None, 1] < bx[..., 0]) | (wb[:, None, 0] > bx[..., 1])
                | (wb[:, None, 3] < bx[..., 2])
                | (wb[:, None, 2] > bx[..., 3]))             # (B, 1, P, K)
        live = (torch.arange(K) < ca[..., None])[:, :, None, :]
        skip = live & ~cull & (x < _f(CUTOFF))
        plain = -plain_x[:, a:a + 1] * inv_sigma
        plain = plain.clamp_min(0.0) + torch.log1p(torch.exp(-plain.abs()))
        for name, m in (("culled", cull & live), ("skipped", skip)):
            bad = m & ~((plain == 0) & ~torch.signbit(plain))
            if bool(bad.any()):
                raise AssertionError(f"the kernel {name} a pair whose plain "
                                     f"term is {float(plain[bad][0])}")
        culled += int((cull & live).sum())
        skipped += int(skip.sum())
        term = torch.where(live & ~cull, softplus_model(x), _f(0.0))
        total = None
        for g in range(G):
            acc = torch.zeros((B, 1, tp))
            for k in range(g, K, G):                        # slot order
                acc = acc + term[..., k]
            total = acc if total is None else total + acc
        S[:, a:a + 1] = total
    return S, culled, skipped


def _check(q, count, tile, inv_s, inv_sigma, sms=132):
    S, culled, skipped = fwd_model(q, count, tile, inv_s, inv_sigma, sms)
    ref = cuda_soft.soft_coverage_fwd_reference(q, count, tile, inv_s,
                                                inv_sigma)
    tol = 1e-4 + 1e-5 * float(ref.abs().max())
    torch.testing.assert_close(S, ref, rtol=0, atol=tol)
    return culled, skipped


def random_slabs(seed, B, A, K, tile, inv_s=1.0 / 16):
    """The card tests' random slabs: corners spread past the tile, random
    counts, tile (0, 0) full and the last tile empty."""
    rng = np.random.default_rng(seed)
    span = tile * inv_s
    q = rng.uniform(-0.3 * span, 1.3 * span, size=(B, A, K, 6))
    count = rng.integers(0, K + 1, size=(B, A))
    count[0, 0] = K
    count[-1, -1] = 0
    return (torch.tensor(q, dtype=torch.float32),
            torch.tensor(count, dtype=torch.int32))


@pytest.mark.parametrize("tile,K,sigma", [(4, 5, 1e-3), (8, 64, 1e-4),
                                          (16, 130, 1e-4), (32, 40, 1e-5),
                                          (5, 40, 1e-4), (25, 20, 1e-3)])
def test_model_on_random_slabs(tile, K, sigma):
    q, count = random_slabs(tile + K, 2, 3, K, tile)
    # a degenerate face (every pixel inside) and a sliver: never culled
    q[0, 0, 0] = torch.tensor([0.1, 0.1, 0.3, 0.3, 0.5, 0.5])
    q[0, 0, 1] = torch.tensor([0.0, 0.0, 2.0, 2.0, 1.0, 1.0 + 1e-7])
    for sms in (132, 1):                  # 4 (or 1) slot groups, then 2
        _check(q, count, tile, 1.0 / 16, 1.0 / sigma, sms)


def test_slot_groups():
    """4 groups for the pose fit's 64 tiles, 2 for the bench's 1024, on an
    H100's 132 SMs; one at tile 32 (1024 threads) and tile 25."""
    assert fwd_groups(16, 64, 132) == 4 and fwd_groups(16, 1024, 132) == 2
    assert fwd_groups(16, 8000, 132) == 1 and fwd_groups(8, 1024, 132) == 4
    assert fwd_groups(32, 1, 132) == 1 and fwd_groups(25, 1, 132) == 1


def _bench_slab():
    """chip_smoke's bench slab, one of its B = 8 identical views: level-3
    icosphere at t = (0, 0, 3), f = 0.8 * 256, 256^2, sigma 1e-4, the
    packed config suggested for it."""
    import torch_renderer_tpu_torch as trt
    from torch_renderer_tpu_torch.rasterize.binning import bin_faces_active
    from torch_renderer_tpu_torch.rasterize.soft import SOFT_CUTOFF

    image, sigma = 256, 1e-4
    verts, faces = trt.icosphere(3)
    f = 0.8 * image
    Km = np.array([[f, 0, image / 2], [0, f, image / 2], [0, 0, 1.0]],
                  np.float32)
    meshes = trt.Meshes.from_single(verts, faces, device="cpu")
    cam = trt.PerspectiveCamera.from_K(Km[None], (image, image),
                                       t=np.array([[0.0, 0.0, 3.0]],
                                                  np.float32), device="cpu")
    fp = trt.setup_face_planes(meshes, cam)
    cfg = trt.suggest_soft_config(fp, (image, image), sigma=sigma,
                                  layout="packed")
    bins = bin_faces_active(fp, (image, image), cfg.tile,
                            math.sqrt(SOFT_CUTOFF * sigma), cfg.active_tiles)
    q, count = cuda_soft.tile_slabs(fp, bins,
                                    min(cfg.faces_per_tile, fp.num_faces))
    return q.detach(), count, cfg.tile, 1.0 / (image / 2.0), 1.0 / sigma


def test_model_on_bench_slab():
    q, count, tile, inv_s, inv_sigma = _bench_slab()
    assert int(count.sum()) == 46944 // 8
    culled, skipped = _check(q, count, tile, inv_s, inv_sigma)
    pairs = int(count.sum()) * tile * tile
    assert culled > 0.05 * pairs and skipped > 0.05 * pairs


def test_model_on_pose_slab():
    """The pose fit's silhouette slab on its pallas route: the app's scene
    (level-3 icosphere in the unit sphere, look_at(2.7, 15, 40)) at 128^2,
    tile 16, the lane layout, sigma 1e-4, every tile active."""
    from torch_renderer_tpu_torch.apps.camera_pose_optimizer import pinhole_K
    from torch_renderer_tpu_torch.cameras.look_at import (
        look_at_view_transform,
    )
    from torch_renderer_tpu_torch.cameras.perspective import (
        PerspectiveCamera,
    )
    from torch_renderer_tpu_torch.ops.icosphere import icosphere
    from torch_renderer_tpu_torch.rasterize.binning import bin_faces_active
    from torch_renderer_tpu_torch.rasterize.geometry import setup_face_planes
    from torch_renderer_tpu_torch.rasterize.soft import SOFT_CUTOFF
    from torch_renderer_tpu_torch.structures.meshes import Meshes

    size, sigma, tile = (128, 128), 1e-4, 16
    meshes = Meshes.from_single(*icosphere(3), device="cpu")
    meshes, _, _ = meshes.center_and_scale_to_unit_sphere()
    R, t = look_at_view_transform(2.7, 15.0, 40.0)
    cam = PerspectiveCamera.from_K(pinhole_K(size), size, R=R[0].numpy(),
                                   t=t[0].numpy(), device="cpu")
    fp = setup_face_planes(meshes, cam)
    bins = bin_faces_active(fp, size, tile, math.sqrt(SOFT_CUTOFF * sigma),
                            64)
    q, count = cuda_soft.tile_slabs(fp, bins, 128)
    culled, skipped = _check(q.detach(), count, tile, 1.0 / 64, 1.0 / sigma)
    assert culled > 0 and skipped > 0


if __name__ == "__main__":
    # the skip shares on the bench slab, from the repository root:
    #   PYTHONPATH=. python tests/test_torch_soft_fwd.py
    q, count, tile, inv_s, inv_sigma = _bench_slab()
    culled, skipped = _check(q, count, tile, inv_s, inv_sigma)
    pairs = int(count.sum()) * tile * tile
    print(f"bench slab (one view): {pairs} live pairs, culled by the warp "
          f"box {culled / pairs:.4f}, softplus skipped {skipped / pairs:.4f}")

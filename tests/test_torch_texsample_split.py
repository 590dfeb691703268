"""CPU models of the texture backward kernel's decomposition
(csrc/texsample.cu, texsample_bwd_kernel) and the wrappers' operand checks.
No JAX, and no card: the kernels themselves are held to their plain
versions by tests/test_torch_cuda_kernels.py on the card.

- The row split: a tap row (c00 || c01, or c10 || c11) is 2C contiguous
  floats, added to d_maps in pieces of 4, 2 or 1 floats (vector atomics)
  by the rule of the kernel's `pieces` (a copy below; its text is read
  from the source). Every float of the row lies in exactly one piece, and
  every piece of 4 or 2 starts on a 16- or 8-byte boundary, for every
  residue of the row's address.
- The warp aggregation: 32-lane windows of points, grouped by their c00
  texel (lanes whose contributions are all exactly zero stay alone), each
  group summed by the kernel's tree (`reduce_peers`) and added once by its
  lowest lane, piece by piece, skipping pieces of zeros. Per-texel totals
  equal texsample_bwd_reference's index_add_ within 1e-6 of the largest
  (float32 sums in another order).
- The zero skip: an empty fragment (uv 0, cotangent 0) adds nothing to its
  texel (Hm - 2, 0).
- Every ValueError of the wrappers' operand check, with its message.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_renderer_tpu_torch.ops import cuda_texsample as ts
from torch_renderer_tpu_torch.structures.textures import bilinear_corners

SOURCE = (Path(__file__).resolve().parents[1] / "torch_renderer_tpu_torch"
          / "csrc" / "texsample.cu")
WARP = 32
FULL = 0xFFFFFFFF


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pieces(n: int, r: int) -> list:
    """[(first float, width)] of a run of n floats whose first float lies r
    floats past a 16-byte boundary: the kernel's rule."""
    out, k = [], 0
    while k < n:
        a = (r + k) & 3
        w = 4 if a == 0 and n - k >= 4 else 2 if a % 2 == 0 and n - k >= 2 \
            else 1
        out.append((k, w))
        k += w
    return out


def test_row_split_rule_is_the_kernels():
    src = SOURCE.read_text()
    rule = re.search(r"constexpr int a = \(R \+ K\) & 3;\s*"
                     r"constexpr int W = \(a == 0 && N - K >= 4\) \? 4\s*"
                     r": \(a % 2 == 0 && N - K >= 2\) \? 2 : 1;", src)
    assert rule, "csrc/texsample.cu's piece rule changed: update pieces()"
    assert "pieces<N, R, K + W>(op);" in src


@pytest.mark.parametrize("r", [0, 1, 2, 3])
@pytest.mark.parametrize("C", [1, 2, 3, 4, 8])
def test_row_split_covers_each_float_once(C, r):
    n = 2 * C
    seen = np.zeros(n, np.int64)
    for k, w in pieces(n, r):
        assert w in (1, 2, 4)
        seen[k:k + w] += 1
        if w > 1:
            assert (r + k) % w == 0, (k, w)   # a 16- or 8-byte boundary
    assert (seen == 1).all()
    # no two pieces that the rule could have merged
    assert len(pieces(n, r)) <= (n + 3) // 4 + 2


# ---------------------------------------------------------------------------
# The warp aggregation and the zero skip
# ---------------------------------------------------------------------------

def contributions(maps, y0, x0, wy, wx, g):
    """Per point, the kernel's values for the rows c00 || c01 and
    c10 || c11 (float32 products in its order), the c00 texel, and
    whether any value is nonzero."""
    _, Hm, Wm, C = maps.shape
    y = np.clip(y0, 0, Hm - 2)
    x = np.clip(x0, 0, Wm - 2)
    ax, ay = wx.astype(np.float32), wy.astype(np.float32)
    one = np.float32(1.0)
    ux, uy = one - ax, one - ay
    w00, w01, w10, w11 = uy * ux, uy * ax, ay * ux, ay * ax
    top = np.concatenate([g * w00[..., None], g * w01[..., None]], -1)
    bot = np.concatenate([g * w10[..., None], g * w11[..., None]], -1)
    live = (top != 0).any(-1) | (bot != 0).any(-1)
    return top, bot, y * Wm + x, live


def reduce_peers(vals, peers):
    """The kernel's tree over each lane's group: vals (32, N) float32,
    peers[l] the lane mask of l's group. Returns every lane's end value
    (the group's total at its lowest lane)."""
    a = vals.copy()
    lanes = np.arange(WARP)
    above = np.array([p & (0xFFFFFFFE << int(l)) & FULL
                      for l, p in zip(lanes, peers)], np.int64)
    rank = np.array([bin(p & ((1 << int(l)) - 1)).count("1")
                     for l, p in zip(lanes, peers)], np.int64)
    while (above != 0).any():
        nxt = np.array([(int(b) & -int(b)).bit_length() - 1 if b else l
                        for l, b in zip(lanes, above)])
        t = a[nxt]                       # every lane reads before any adds
        a = np.where((above != 0)[:, None], a + t, a)
        ballot = sum(1 << int(l) for l in lanes if rank[l] % 2 == 0)
        above &= ballot
        rank >>= 1
    return a


def model_d_maps(maps, y0, x0, wy, wx, g, r=0):
    """d_maps as the kernel builds it: per view, blocks of 128 points in 4
    warps of 32, groups by texel, one leader a group adding its rows piece
    by piece (pieces of zeros skipped) into a map whose first float lies r
    floats past a 16-byte boundary. Returns (d_maps, atomics made, live
    points)."""
    B, Hm, Wm, C = maps.shape
    P = y0.shape[1]
    top, bot, texel, live = contributions(maps, y0, x0, wy, wx, g)
    d = np.zeros((B, Hm * Wm * C), np.float32)
    atomics = 0
    for b in range(B):
        for w0 in range(0, P, WARP):
            sl = slice(w0, min(w0 + WARP, P))
            n = sl.stop - sl.start
            key = np.array([-1 - l for l in range(WARP)], np.int64)
            key[:n] = np.where(live[b, sl], texel[b, sl], key[:n])
            peers = [sum(1 << m for m in range(WARP) if key[m] == key[l])
                     for l in range(WARP)]
            tv = np.zeros((WARP, 2 * C), np.float32)
            bv = np.zeros((WARP, 2 * C), np.float32)
            tv[:n], bv[:n] = top[b, sl], bot[b, sl]
            tv, bv = reduce_peers(tv, peers), reduce_peers(bv, peers)
            for lane in range(n):
                if key[lane] < 0 or peers[lane] & ((1 << lane) - 1):
                    continue                       # not a group's leader
                for row, v in ((key[lane] * C, tv[lane]),
                               ((key[lane] + Wm) * C, bv[lane])):
                    for k, w in pieces(2 * C, (r + row) % 4):
                        if (v[k:k + w] != 0).any():
                            d[b, row + k:row + k + w] += v[k:k + w]
                            atomics += 1
    return d.reshape(B, Hm, Wm, C), atomics, int(live.sum())


def _inputs(seed, B, Hm, Wm, C, P, layout):
    rng = np.random.default_rng(seed)
    maps = rng.uniform(size=(B, Hm, Wm, C)).astype(np.float32)
    g = rng.normal(size=(B, P, C)).astype(np.float32)
    g[rng.uniform(size=g.shape) < 0.1] = 0.0     # pieces with some zeros
    if layout == "uniform":
        uv = rng.uniform(size=(B, P, 2))
    else:
        # warps on one texel and its neighbours, as the fit's fragments;
        # a third of the points empty (uv 0, cotangent 0)
        c = rng.uniform(0.1, 0.9, size=(B, P // WARP + 1, 1, 2))
        jit = rng.uniform(-1.5, 1.5, size=(B, P // WARP + 1, WARP, 2))
        uv = (c + jit / np.array([Wm - 1, Hm - 1])).reshape(B, -1, 2)[:, :P]
        empty = rng.uniform(size=(B, P)) < 0.3
        uv[empty] = 0.0
        g[empty] = 0.0
    y0, x0, wy, wx = bilinear_corners(
        torch.tensor(uv, dtype=torch.float32), Hm, Wm)
    return maps, y0.numpy(), x0.numpy(), wy.numpy(), wx.numpy(), g


@pytest.mark.parametrize("B,Hm,Wm,C,P,layout", [
    (2, 16, 16, 3, 300, "uniform"), (2, 16, 16, 3, 300, "cluster"),
    (1, 9, 7, 1, 161, "cluster"), (2, 9, 7, 4, 200, "cluster"),
    (1, 12, 10, 8, 128, "cluster"), (1, 33, 31, 3, 257, "uniform"),
])
@pytest.mark.parametrize("r", [0, 3])
def test_warp_aggregation_matches_index_add(B, Hm, Wm, C, P, layout, r):
    maps, y0, x0, wy, wx, g = _inputs(7, B, Hm, Wm, C, P, layout)
    d, atomics, live = model_d_maps(maps, y0, x0, wy, wx, g, r)
    ref = ts.texsample_bwd_reference(
        torch.tensor(maps), torch.tensor(y0), torch.tensor(x0),
        torch.tensor(wy), torch.tensor(wx), torch.tensor(g))[0].numpy()
    tol = 1e-6 * float(np.abs(ref).max())
    assert float(np.abs(d - ref).max()) <= tol
    # at most one group's pieces per live point, and at most 4 pieces a
    # row (two rows a point)
    assert atomics <= live * 2 * len(pieces(2 * C, 1))
    if layout == "cluster":       # the aggregation merges neighbours
        assert atomics < live * 2 * len(pieces(2 * C, 0))


def test_empty_fragments_leave_their_texel_untouched():
    B, Hm, Wm, C, P = 1, 16, 16, 3, 256
    maps, y0, x0, wy, wx, g = _inputs(3, B, Hm, Wm, C, P, "uniform")
    # the first half empty (uv 0, cotangent 0); the rest kept off the
    # corner (0, 0) of the map's last two rows
    uv = np.zeros((B, P // 2, 2), np.float32)
    ey0, ex0, ewy, ewx = (a.numpy() for a in bilinear_corners(
        torch.tensor(uv), Hm, Wm))
    assert (ey0 == Hm - 2).all() and (ex0 == 0).all() and (ewy == 1).all()
    y0[:, :P // 2], x0[:, :P // 2] = ey0, ex0
    wy[:, :P // 2], wx[:, :P // 2] = ewy, ewx
    g[:, :P // 2] = 0.0
    x0[:, P // 2:] = np.clip(x0[:, P // 2:], 2, Wm - 2)
    d, atomics, live = model_d_maps(maps, y0, x0, wy, wx, g)
    assert live == P - P // 2
    corner = d[0, Hm - 2:, :2]
    assert (corner == 0.0).all() and not np.signbit(corner).any()
    ref = ts.texsample_bwd_reference(
        torch.tensor(maps), torch.tensor(y0), torch.tensor(x0),
        torch.tensor(wy), torch.tensor(wx), torch.tensor(g))[0].numpy()
    assert (ref[0, Hm - 2:, :2] == 0.0).all()


# ---------------------------------------------------------------------------
# The operand checks
# ---------------------------------------------------------------------------

def _ops(B=2, Hm=8, Wm=8, C=3, P=5):
    maps = torch.zeros((B, Hm, Wm, C))
    idx = torch.zeros((B, P), dtype=torch.int32)
    w = torch.zeros((B, P))
    return maps, idx, idx.clone(), w, w.clone(), torch.zeros((B, P, C))


def _bad(case):
    maps, y0, x0, wy, wx, g = _ops()
    if case == "device":
        maps = maps.to("meta")
    elif case == "maps_dtype":
        maps = maps.double()
    elif case == "maps_ndim":
        maps = maps[0]
    elif case == "maps_2x2":
        maps = maps[:, :1]
    elif case == "y0_shape":
        y0 = torch.zeros((3, 5), dtype=torch.int32)
    elif case == "y0_dtype":
        y0 = y0.long()
    elif case == "x0_shape":
        x0 = torch.zeros((2, 4), dtype=torch.int32)
    elif case == "wy_dtype":
        wy = wy.double()
    elif case == "wx_shape":
        wx = torch.zeros((2, 6))
    elif case == "g":
        g = torch.zeros((2, 5, 4))
    elif case == "same_device":
        wx = wx.to("meta")
    return maps, y0, x0, wy, wx, g


CHECKS = {
    "device": "no texture-sampling kernel for device meta",
    "maps_dtype": "maps must be float32 (B, Hm, Wm, C), got torch.float64 "
                  "(2, 8, 8, 3)",
    "maps_ndim": "maps must be float32 (B, Hm, Wm, C), got torch.float32 "
                 "(8, 8, 3)",
    "maps_2x2": "maps must be at least 2x2 with a channel, got (2, 1, 8, 3)",
    "y0_shape": "y0 must be (B=2, P), got (3, 5)",
    "y0_dtype": "y0 must be torch.int32 (2, 5), got torch.int64 (2, 5)",
    "x0_shape": "x0 must be torch.int32 (2, 5), got torch.int32 (2, 4)",
    "wy_dtype": "wy must be torch.float32 (2, 5), got torch.float64 (2, 5)",
    "wx_shape": "wx must be torch.float32 (2, 5), got torch.float32 (2, 6)",
    "g": "g must be float32 (2, 5, 3), got torch.float32 (2, 5, 4)",
    "same_device": "maps, y0, x0, wy, wx and g must be on one device",
}


@pytest.mark.parametrize("case", sorted(CHECKS))
def test_operand_check_raises(case):
    maps, y0, x0, wy, wx, g = _bad(case)
    with pytest.raises(ValueError, match=re.escape(CHECKS[case]) + "$"):
        if case == "g":
            ts.texsample_bwd(maps, y0, x0, wy, wx, g)
        else:
            ts.texsample_fwd(maps, y0, x0, wy, wx)
    with pytest.raises(ValueError, match=re.escape(CHECKS[case]) + "$"):
        ts.texsample_bwd(maps, y0, x0, wy, wx, g)


@pytest.mark.parametrize("case", ["corners", "cotangent", "map_view",
                                  "map_batch"])
def test_cuda_layout_raises(case):
    maps, y0, x0, wy, wx, g = _ops()
    if case == "corners":
        x0 = torch.zeros((5, 2), dtype=torch.int32).t()
    elif case == "cotangent":
        g = torch.zeros((2, 3, 5)).transpose(1, 2)
    elif case == "map_view":
        maps = torch.zeros((2, 8, 8, 3)).transpose(1, 2)
    else:
        maps = torch.zeros((2, 8, 8, 6))[..., :3]
    if case in ("corners", "cotangent"):
        msg = ("the CUDA kernels take contiguous corner, weight and "
               "cotangent tensors")
    else:
        msg = ("the CUDA kernels take a map whose views are contiguous, "
               "stacked or broadcast (batch stride 0 or 192); got strides "
               f"{maps.stride()}")
    with pytest.raises(ValueError, match=re.escape(msg) + "$"):
        ts._cuda_layout(maps, y0, x0, wy, wx, g)


def test_cuda_layout_strides():
    maps, y0, x0, wy, wx, g = _ops()
    assert ts._cuda_layout(maps, y0, x0, wy, wx, g) == 192
    shared = maps[:1].expand(2, -1, -1, -1)
    assert ts._cuda_layout(shared, y0, x0, wy, wx) == 0
    # a channel axis of one may have any stride (maps[0] is contiguous)
    one = torch.zeros(128).as_strided((2, 8, 8, 1), (64, 8, 1, 5))
    assert one[0].is_contiguous()
    assert ts._cuda_layout(one, y0, x0, wy, wx) == 64
    # but its texels must be adjacent
    odd = torch.zeros((2, 8, 8, 2))[..., :1]
    assert not odd[0].is_contiguous()
    with pytest.raises(ValueError):
        ts._cuda_layout(odd, y0, x0, wy, wx)
    single = torch.zeros((1, 8, 8, 3))
    assert ts._cuda_layout(single, y0[:1], x0[:1], wy[:1], wx[:1]) == 192


def test_packed_arguments_match_the_kernels_struct():
    """The wrapper's struct format names TexArgs's fields in order."""
    body = re.search(r"struct TexArgs \{(.*?)\};", SOURCE.read_text(),
                     re.S).group(1)
    codes = ""
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        kind = "P" if "*" in decl else "q" if decl.startswith("long long") \
            else "i"
        codes += kind * (decl.count(",") + 1 if kind == "i" else 1)
    assert "@" + codes == ts._ARGS.format
    assert ts._ARGS.size == 11 * 8 + 6 * 4

"""The tile-gather forward kernel's launch plan (rasterize/cuda_gather.py
``gather_plan``) on the CPU, and a plain-torch model of how
csrc/gather_tiles.cu ``gather_fwd_kernel`` covers a slab with it: each row
splits into a head of single floats up to its first 16-byte boundary,
units of 4 floats (one 16-byte store each) and a tail (``row_split``);
block (row, chunk) reads the ids of the slots its floats span once, writes
its units, the row's first block the head and its last block the tail,
exact zeros in dead slots. The model must equal ``gather_tiles_reference``
(a copy: bit for bit) for int32 and int64 ids, ids outside [0, F) and an
all-dead row. No JAX here.
"""

import numpy as np
import pytest
import torch

from torch_renderer_tpu_torch.rasterize import cuda_gather as cg


@pytest.mark.parametrize("S,C,plan", [
    (128, 6, (192, 1)),     # the soft slab
    (224, 13, (256, 3)),    # the fragments route's hard slab
    (192, 13, (256, 3)),    # the pallas route's hard slab
    (45, 13, (160, 1)),     # the depth call's slab: rows of 2340 bytes
    (1, 3, (32, 1)),        # a row shorter than one 16-byte store
    (400, 13, (256, 6)),
])
def test_plan(S, C, plan):
    p = cg.gather_plan(S, C)
    assert tuple(p) == plan
    assert p.threads % 32 == 0 and p.threads <= cg.MAX_FWD_THREADS
    assert p.chunks * p.threads >= S * C // 4


def row_split(L: int, row: int):
    """(head, units, tail): how the kernel writes row `row` of L floats of
    a slab that starts on a 16-byte boundary (every allocation does): head
    single floats up to the row's first 16-byte boundary, units of 4
    floats, then tail single floats."""
    head = min(-(row * L) % 4, L)
    units = (L - head) // 4
    return head, units, L - head - units * 4


@pytest.mark.parametrize("S,C", [(128, 6), (224, 13), (192, 13), (45, 13),
                                 (3, 3), (7, 1), (1, 3)])
def test_row_split(S, C):
    """Rows whose byte size is a multiple of 16 take 16-byte stores only;
    the others a head up to their first 16-byte boundary and a tail of
    at most 3 floats."""
    L = S * C
    heads = set()
    for row in range(12):
        head, units, tail = row_split(L, row)
        assert head + units * 4 + tail == L
        assert 0 <= head < 4 and 0 <= tail < 4
        if units:
            assert (row * L + head) % 4 == 0      # the body is 16-byte aligned
        if L % 4 == 0:
            assert head == 0 and tail == 0
        heads.add(head)
    if L % 4 and L >= 4:
        assert heads == {0, 1, 2, 3}


def plan_model(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The forward kernel's writes under its plan, in plain torch: unwritten
    floats stay NaN."""
    B, T, S = idx.shape
    F, C = table.shape[1:]
    L = S * C
    plan = cg.gather_plan(S, C)
    out = torch.full((B * T, L), float("nan"))
    rows = idx.reshape(B * T, S).long()
    for row in range(B * T):
        tb = table[row // T].reshape(-1)
        head, nv, tail = row_split(L, row)
        for chunk in range(plan.chunks):
            u0 = min(chunk * plan.threads, nv)
            u1 = min(u0 + plan.threads, nv)
            first, last = chunk == 0, chunk == plan.chunks - 1
            e0 = 0 if first else head + u0 * 4
            e1 = L if last else head + u1 * 4
            if e1 <= e0:
                continue
            s0, s1 = e0 // C, (e1 - 1) // C + 1
            ids = rows[row, s0:s1]                        # read once each
            sid = torch.where((ids >= 0) & (ids < F), ids, -1)
            mine = list(range(head + u0 * 4, head + u1 * 4))
            if first:
                mine += list(range(head))
            if last:
                mine += list(range(L - tail, L))
            e = torch.tensor(mine, dtype=torch.int64)
            assert bool(torch.isnan(out[row, e]).all())   # written once
            s = e // C
            i = sid[s - s0]
            out[row, e] = torch.where(
                i >= 0, tb[(i.clamp_min(0) * C + e - s * C)],
                torch.zeros(()))
    return out.reshape(B, T, S, C)


def _case(seed, B, T, S, F, C, dtype):
    """Per tile a prefix of live slots whose ids range over [-3, F + 3),
    -1 after it; row (0, 0) all dead."""
    rng = np.random.default_rng(seed)
    idx = np.full((B, T, S), -1, np.int64)
    for b in range(B):
        for t in range(T):
            n = rng.integers(0, S + 1)
            idx[b, t, :n] = rng.integers(-3, F + 3, size=n)
    idx[0, 0] = -1
    table = rng.standard_normal((B, F, C)).astype(np.float32)
    return torch.tensor(idx, dtype=dtype), torch.from_numpy(table)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("B,T,S,F,C", [(2, 3, 128, 40, 6), (1, 4, 45, 50, 13),
                                       (1, 2, 224, 300, 13), (2, 5, 7, 9, 1),
                                       (1, 3, 1, 4, 3)])
def test_plan_model_equals_plain(dtype, B, T, S, F, C):
    idx, table = _case(B + T + S, B, T, S, F, C, dtype)
    out = plan_model(idx, table)
    assert torch.equal(out, cg.gather_tiles_reference(idx, table))
    assert bool((out[0, 0] == 0).all())

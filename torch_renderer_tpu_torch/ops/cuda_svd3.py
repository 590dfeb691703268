"""Batched 3x3 singular value decomposition through a hand-written CUDA
kernel (``csrc/svd3.cu``), for the ICP's alignment step (ops/icp.umeyama).

The kernel replaces no Pallas kernel: the JAX package takes
``jnp.linalg.svd`` (torch_renderer_tpu/ops/icp.py:68), which XLA lowers
inside the registration's one compiled program. ``torch.linalg.svd`` on a
CUDA tensor reads the solver's status back to the host, so a loop over it
waits for the host every step and cannot be captured as a CUDA graph; the
kernel reads nothing back.

``svd3`` launches the kernel for a CUDA tensor and takes
``torch.linalg.svd`` (LAPACK, as the JAX package's CPU SVD) for a tensor on
the CPU. ``svd3_jacobi`` is the kernel's arithmetic in plain PyTorch (the
same sweeps, ordering and completion of u), the version the kernel is held
against on the card. ``det3`` is the closed-form 3x3 determinant the ICP
takes det(U Vt) from (``torch.linalg.det`` factors the matrix instead).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .._build import launch
from ..utils.timing import count as count_event

# Each launch adds 1 to the utils.timing counter "svd3": the launches made
# from the host (an eager call, a graph's warm-up or capture); a replay
# launches from its graph and counts nothing.

SWEEPS = 8   # kSweeps in csrc/svd3.cu


def det3(m: torch.Tensor) -> torch.Tensor:
    """det of (..., 3, 3) matrices by cofactor expansion along row 0."""
    (a, b, c), (d, e, f), (g, h, i) = (r.unbind(-1) for r in m.unbind(-2))
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _dot(x, y):
    return (x * y).sum(-1)


def svd3_jacobi(a: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: (u, s, vt) of (..., 3, 3) float32
    matrices, s descending, by one-sided Jacobi on the columns of
    B = A V (see csrc/svd3.cu)."""
    shape = a.shape[:-2]
    a = a.reshape(-1, 3, 3)
    n = a.shape[0]
    b = list(a.transpose(1, 2).unbind(1))          # columns, (n, 3) each
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    v = [eye[j].expand(n, 3) for j in range(3)]
    one = torch.ones((), dtype=a.dtype, device=a.device)
    for _ in range(SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            alpha, beta = _dot(b[p], b[p]), _dot(b[q], b[q])
            gamma = _dot(b[p], b[q])
            skip = gamma == 0
            zeta = (beta - alpha) / (2.0 * torch.where(skip, one, gamma))
            t = torch.copysign(one, zeta) / (zeta.abs()
                                             + torch.sqrt(1.0 + zeta * zeta))
            c = torch.where(skip, one, 1.0 / torch.sqrt(1.0 + t * t))
            s = torch.where(skip, 0.0, c * t)
            c, s = c[:, None], s[:, None]
            b[p], b[q] = c * b[p] - s * b[q], s * b[p] + c * b[q]
            v[p], v[q] = c * v[p] - s * v[q], s * v[p] + c * v[q]
    nrm = [torch.sqrt(_dot(x, x)) for x in b]
    for i, j in ((0, 1), (1, 2), (0, 1)):
        swap = nrm[i] < nrm[j]
        sw = swap[:, None]
        nrm[i], nrm[j] = (torch.where(swap, nrm[j], nrm[i]),
                          torch.where(swap, nrm[i], nrm[j]))
        b[i], b[j] = torch.where(sw, b[j], b[i]), torch.where(sw, b[i], b[j])
        v[i], v[j] = torch.where(sw, v[j], v[i]), torch.where(sw, v[i], v[j])

    u0 = torch.where((nrm[0] > 0)[:, None],
                     b[0] / torch.where(nrm[0] > 0, nrm[0], one)[:, None],
                     eye[0])
    u1 = b[1] - _dot(u0, b[1])[:, None] * u0
    n1 = torch.sqrt(_dot(u1, u1))
    # the unit axis least aligned with u0, minus its u0 part
    ax = u0.abs()
    k = torch.where((ax[:, 0] <= ax[:, 1]) & (ax[:, 0] <= ax[:, 2]), 0,
                    torch.where(ax[:, 1] <= ax[:, 2], 1, 2))
    alt = eye[k] - u0.gather(1, k[:, None]) * u0
    u1 = torch.where((n1 > 0)[:, None], u1, alt)
    u1 = u1 / torch.sqrt(_dot(u1, u1))[:, None]
    u2 = torch.linalg.cross(u0, u1, dim=-1)
    u2 = torch.where((_dot(u2, b[2]) < 0)[:, None], -u2, u2)
    u = torch.stack([u0, u1, u2], dim=-1)
    s = torch.stack(nrm, dim=-1)
    vt = torch.stack(v, dim=-2)
    return (u.reshape(shape + (3, 3)), s.reshape(shape + (3,)),
            vt.reshape(shape + (3, 3)))


def svd3(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(u, s, vt) of (..., 3, 3) float32 matrices, a = u diag(s) vt, s
    descending: the kernel for a CUDA tensor, torch.linalg.svd for a CPU
    one; anything else raises."""
    if a.shape[-2:] != (3, 3) or a.dtype != torch.float32:
        raise ValueError(f"svd3 takes (..., 3, 3) float32 matrices, got "
                         f"{tuple(a.shape)} {a.dtype}")
    if a.device.type == "cpu":
        return torch.linalg.svd(a)
    if a.device.type != "cuda":
        raise ValueError(f"svd3: unsupported device {a.device}")
    shape = a.shape[:-2]
    flat = a.reshape(-1, 9).contiguous()
    n = flat.shape[0]
    u = torch.empty((n, 3, 3), dtype=a.dtype, device=a.device)
    vt = torch.empty_like(u)
    s = torch.empty((n, 3), dtype=a.dtype, device=a.device)
    if n:
        launch("trt_svd3", flat.data_ptr(), u.data_ptr(), s.data_ptr(),
               vt.data_ptr(), n, device=a.device)
        count_event("svd3")
    return (u.reshape(shape + (3, 3)), s.reshape(shape + (3,)),
            vt.reshape(shape + (3, 3)))

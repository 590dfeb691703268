"""The hand-written CUDA soft-coverage kernels against their plain PyTorch
versions, on an NVIDIA GPU. Marked ``cuda``: without a card every test here
skips (the decision is made in a fixture, never at import).

Tolerances: forward sums within 1e-4 + 1e-5 * max|S| (float32 sums in
another order); backward within 1e-3 of max|dq| (another order and form of
the pixel sums).
"""

import numpy as np
import pytest
import torch

from torch_renderer_tpu_torch.rasterize import cuda_soft

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _slabs(seed, B, A, K, tile, device, inv_s=1.0 / 16):
    rng = np.random.default_rng(seed)
    span = tile * inv_s
    q = rng.uniform(-0.3 * span, 1.3 * span, size=(B, A, K, 6))
    count = rng.integers(0, K + 1, size=(B, A))
    count[0, 0] = K          # one full tile
    count[-1, -1] = 0        # one empty tile
    return (torch.tensor(q, dtype=torch.float32, device=device),
            torch.tensor(count, dtype=torch.int32, device=device))


# K=300 streams three shared-memory chunks in the forward and loops the
# backward's threads over slots; tile=32 is the 1024-thread maximum.
@pytest.mark.parametrize("B,A,K,tile,sigma", [
    (2, 3, 5, 4, 1e-3), (2, 7, 64, 8, 1e-4), (1, 5, 300, 16, 1e-4),
    (3, 2, 40, 32, 1e-4),
])
def test_kernels_match_plain(device, B, A, K, tile, sigma):
    q, count = _slabs(0, B, A, K, tile, device)
    inv_s, inv_sigma = 1.0 / 16, 1.0 / sigma
    g = torch.rand((B, A, tile * tile), device=device)
    before = (cuda_soft.FWD_LAUNCHES, cuda_soft.BWD_LAUNCHES)
    S = cuda_soft.soft_coverage_fwd(q, count, tile, inv_s, inv_sigma)
    dq = cuda_soft.soft_coverage_bwd(q, count, g, tile, inv_s, inv_sigma)
    torch.cuda.synchronize()
    assert (cuda_soft.FWD_LAUNCHES, cuda_soft.BWD_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    S_ref = cuda_soft.soft_coverage_fwd_reference(q, count, tile, inv_s,
                                                  inv_sigma)
    dq_ref = cuda_soft.soft_coverage_bwd_reference(q, count, g, tile, inv_s,
                                                   inv_sigma)
    torch.testing.assert_close(S, S_ref, rtol=0,
                               atol=1e-4 + 1e-5 * float(S_ref.abs().max()))
    torch.testing.assert_close(dq, dq_ref, rtol=0,
                               atol=1e-3 * float(dq_ref.abs().max()))
    assert (S[-1, -1] == 0).all() and (dq[-1, -1] == 0).all()


def test_fused_path_matches_cpu(device):
    """soft_silhouette_fd and its vertex gradient on the card against the
    same call on the CPU (plain versions)."""
    import torch_renderer_tpu_torch as trt

    verts, faces = trt.icosphere(2)
    f = 0.8 * 64
    K = np.array([[f, 0, 32], [0, f, 32], [0, 0, 1]], np.float32)
    t = np.array([[0.0, 0.0, 3.0], [0.2, -0.1, 2.5]], np.float32)
    out = {}
    for dev in ("cpu", device):
        meshes = trt.Meshes.from_single(verts, faces, device=dev).extend(2)
        cam = trt.PerspectiveCamera.from_K(K, (64, 64), t=t, device=dev)
        v = meshes.verts.clone().requires_grad_(True)
        fp = trt.setup_face_planes(meshes.update_padded(v), cam)
        cfg = trt.suggest_soft_config(fp, (64, 64), layout="packed")
        alpha = trt.soft_silhouette_fd(fp, (64, 64), **cfg.kwargs())
        alpha.sum().backward()
        out[str(dev)] = (alpha.detach().cpu(), v.grad.cpu())
    (a_cpu, g_cpu), (a_gpu, g_gpu) = out["cpu"], out[str(device)]
    torch.testing.assert_close(a_gpu, a_cpu, rtol=0, atol=1e-4)
    torch.testing.assert_close(g_gpu, g_cpu, rtol=0,
                               atol=1e-3 * float(g_cpu.abs().max()))


def test_wrapper_rejects_strided_input(device):
    q, count = _slabs(1, 2, 3, 8, 8, device)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_soft.soft_coverage_fwd(q.transpose(0, 1), count.t(), 8,
                                    1.0 / 16, 1e4)

"""Diagonal-covariance Gaussian mixture model: EM fit and sampling on the
device (PyTorch counterpart of ``torch_renderer_tpu.ops.gmm``).

It replaces sklearn.mixture.GaussianMixture in the GMM pose search (the
reference fits and samples on the host every iteration,
pytorch3d_icp_evaluation.py:185,205-239). Seeding is k-means++-style: the
first centre uniform, each next one drawn with probability proportional to
the squared distance from the chosen ones.

Categorical draws are Gumbel-max (argmax of the logits plus Gumbel noise),
as JAX's ``random.categorical``. The public functions draw from a
``torch.Generator``; each has a private form that takes its draws as
tensors (``_kmeanspp_centers``, ``_gmm_sample_from``) and a leading batch
of independent problems, which the pose search's captured loop runs on
draws made before the loop. ``_gmm_em`` is the EM from given centres.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .._device import draw


@dataclasses.dataclass(frozen=True)
class DiagGMM:
    weights: torch.Tensor  # (..., K)
    means: torch.Tensor    # (..., K, D)
    var: torch.Tensor      # (..., K, D) diagonal covariances


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from uniform draws in [0, 1)."""
    tiny = torch.finfo(u.dtype).tiny
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def _kmeanspp_centers(X: torch.Tensor, k: int, first: torch.Tensor,
                      gumbel: torch.Tensor) -> torch.Tensor:
    """k-means++ centres (G, k, D) of X (G, n, D) from the draws: first
    (G,) the first centre's row, gumbel (G, k - 1, n) the noise of each
    later centre's categorical draw over log squared distances."""
    G, n, D = X.shape
    rows = [X.gather(1, first.view(G, 1, 1).expand(G, 1, D))]
    for i in range(1, k):
        centers = torch.cat(rows, dim=1)                  # (G, i, D)
        d2 = ((X[:, :, None, :] - centers[:, None]) ** 2).sum(-1).amin(-1)
        logits = torch.log(d2.clamp_min(1e-12))
        idx = (logits + gumbel[:, i - 1]).argmax(-1)
        rows.append(X.gather(1, idx.view(G, 1, 1).expand(G, 1, D)))
    return torch.cat(rows, dim=1)


def _kmeanspp_init(generator: torch.Generator, X: torch.Tensor,
                   k: int) -> torch.Tensor:
    """k-means++ centres (k, D) of X (N, D), drawn from generator."""
    n = X.shape[0]
    first = torch.randint(0, n, (1,), generator=generator,
                          device=generator.device).to(X.device)
    gumbel = _gumbel(draw(torch.rand, generator, (1, k - 1, n), X.device))
    return _kmeanspp_centers(X[None], k, first, gumbel)[0]


def _log_joint(X, weights, means, var):
    """log w_k N(x_n | mu_k, var_k), (..., N, K)."""
    diff = X[..., :, None, :] - means[..., None, :, :]
    return (-0.5 * (diff * diff / var[..., None, :, :]).sum(-1)
            - 0.5 * torch.log(2.0 * math.pi * var).sum(-1)[..., None, :]
            + torch.log(weights.clamp_min(1e-12))[..., None, :])


def _gmm_em(X: torch.Tensor, means: torch.Tensor, n_iter: int,
            reg_covar: float) -> DiagGMM:
    """n_iter EM steps of a diagonal GMM on X (..., N, D) from the centres
    means (..., K, D), equal weights and every component at X's variance
    (+ reg_covar).

    The EM runs in float64 and returns X's dtype: its sums over the points
    then round to the same float32 whatever order the card adds them in,
    an order that follows the batch's size, so one target's fit does not
    depend on the batch around it (the sharded search_batch splits it)."""
    dtype = X.dtype
    X, means = X.to(torch.float64), means.to(torch.float64)
    n, d = X.shape[-2:]
    K = means.shape[-2]
    var = (X.var(dim=-2, correction=0) + reg_covar)[..., None, :].expand(
        means.shape)
    weights = torch.full(means.shape[:-1], 1.0 / K, dtype=X.dtype,
                         device=X.device)
    for _ in range(n_iter):
        logp = _log_joint(X, weights, means, var)
        r = torch.exp(logp - torch.logsumexp(logp, dim=-1, keepdim=True))
        nk = r.sum(-2).clamp_min(1e-8)                     # (..., K)
        means = (r.transpose(-1, -2) @ X) / nk[..., None]
        d2 = (X[..., :, None, :] - means[..., None, :, :]) ** 2
        var = torch.einsum("...nk,...nkd->...kd", r, d2) / nk[..., None] \
            + reg_covar
        weights = nk / n
    return DiagGMM(weights=weights.to(dtype), means=means.to(dtype),
                   var=var.to(dtype))


def gmm_fit(generator: torch.Generator, X: torch.Tensor, n_components: int,
            n_iter: int = 20, reg_covar: float = 1e-6) -> DiagGMM:
    """EM fit of a diagonal GMM to X (N, D), seeded by k-means++ draws
    from generator."""
    return _gmm_em(X, _kmeanspp_init(generator, X, n_components), n_iter,
                   reg_covar)


def _gmm_sample_from(gmm: DiagGMM, gumbel: torch.Tensor,
                     normal: torch.Tensor) -> torch.Tensor:
    """Samples (..., n, D) of gmm from the draws: gumbel (..., n, K) picks
    each sample's component, normal (..., n, D) its offset."""
    logits = torch.log(gmm.weights.clamp_min(1e-12))[..., None, :]
    comp = (logits + gumbel).argmax(-1)                     # (..., n)
    idx = comp[..., None].expand(normal.shape)
    mu = gmm.means.gather(-2, idx)
    sd = torch.sqrt(gmm.var.gather(-2, idx))
    return mu + sd * normal


def gmm_sample(generator: torch.Generator, gmm: DiagGMM,
               n: int) -> torch.Tensor:
    """n samples (n, D), drawn from generator."""
    K, D = gmm.means.shape
    dev = gmm.means.device
    return _gmm_sample_from(gmm, _gumbel(draw(torch.rand, generator, (n, K),
                                              dev)),
                            draw(torch.randn, generator, (n, D), dev))


def gmm_log_prob(gmm: DiagGMM, X: torch.Tensor) -> torch.Tensor:
    """Log density of X (N, D) under the mixture, (N,)."""
    return torch.logsumexp(_log_joint(X, gmm.weights, gmm.means, gmm.var),
                           dim=-1)

"""Host-side plots of the pose search (counterpart of part of
``torch_renderer_tpu.utils.plotting``): the GMM-ellipse scatter plot of
the reference's GMM.py:10-26 (duplicated at
pytorch3d_icp_evaluation.py:72-114) and a Gaussian's 3D wireframe (its
3D_Gaussian_plot.py). matplotlib is imported when a plot is drawn, and a
missing matplotlib raises there; tensors are read back to the host.
``image_grid`` is not ported yet (ROADMAP Queue 1 item 25).
"""

from __future__ import annotations

import numpy as np


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _pyplot():
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError("plotting needs matplotlib, which is not "
                          "installed") from e
    return plt


def plot_gaussian_wireframe(mean, cov, ax=None, n_std: float = 2.0,
                            n: int = 24):
    """3D wireframe of a Gaussian's n_std ellipsoid; returns the axes."""
    plt = _pyplot()
    mean = _host(mean).astype(np.float64).reshape(3)
    cov = _host(cov).astype(np.float64).reshape(3, 3)
    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
    w, V = np.linalg.eigh(cov)
    radii = n_std * np.sqrt(np.clip(w, 0, None))
    u = np.linspace(0, 2 * np.pi, n)
    v = np.linspace(0, np.pi, n)
    sphere = np.stack(
        [np.outer(np.cos(u), np.sin(v)), np.outer(np.sin(u), np.sin(v)),
         np.outer(np.ones_like(u), np.cos(v))], axis=-1)   # (n, n, 3)
    pts = sphere * radii[None, None] @ V.T + mean
    ax.plot_wireframe(pts[..., 0], pts[..., 1], pts[..., 2],
                      rstride=2, cstride=2, alpha=0.4)
    return ax


def plot_gmm_ellipses(gmm, points=None, ax=None, n_std: float = 2.0):
    """Scatter 2D points with the GMM's covariance ellipses overlaid, for
    a DiagGMM over its first 2 dims; returns the axes."""
    plt = _pyplot()
    from matplotlib.patches import Ellipse

    if ax is None:
        _, ax = plt.subplots()
    if points is not None:
        pts = _host(points)
        ax.scatter(pts[:, 0], pts[:, 1], s=4, alpha=0.5)
    means = _host(gmm.means)[:, :2]
    var = _host(gmm.var)[:, :2]
    weights = _host(gmm.weights)
    for mu, v, w in zip(means, var, weights):
        ax.add_patch(Ellipse(
            mu, 2 * n_std * np.sqrt(v[0]), 2 * n_std * np.sqrt(v[1]),
            alpha=min(0.8, max(0.1, float(w))), facecolor="C1",
            edgecolor="k"))
    return ax

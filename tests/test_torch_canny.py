"""The port's Canny edge pipeline (ops/canny.py) against the JAX package's
canny_edges and against the torch oracle of the reference semantics
(tests/test_canny.py's _torch_reference_canny), on the same seeded numpy
images.

Tolerances: blurred within 1e-3, magnitudes within 1e-2 (0-255 inputs: the
unnormalized blur amplifies, so magnitudes reach the thousands and the
convolutions' summation order shows in the last bits), orientation within
1e-3 except where the summed gradient's angle sits on a rounding boundary.
The NMS keep mask must be equal except at pixels whose magnitude is
within 1e-3 of a neighbour's (a strict comparison of near-equal floats);
thresholded equal except within 1e-3 of the threshold. The JAX tests'
gates (square edges, thinning, shapes, differentiability) hold too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_canny import _torch_reference_canny
from torch_renderer_tpu.ops import canny as jcanny
from torch_renderer_tpu_torch.ops import canny


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_square_image(size=48, lo=0.0, hi=255.0):
    img = np.full((size, size), lo, np.float32)
    img[12:36, 12:36] = hi
    return img[None, :, :, None]


def _near_ties(mag, tol):
    """Pixels whose magnitude is within tol of any 8-neighbour's."""
    p = np.pad(mag, [(0, 0), (1, 1), (1, 1)], constant_values=-1e9)
    H, W = mag.shape[1:]
    near = np.zeros(mag.shape, bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                nb = p[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                near |= np.abs(mag - nb) <= tol
    return near


def test_gaussian_kernel_matches_jax():
    for norm in (True, False):
        np.testing.assert_allclose(
            canny.gaussian_kernel_1d(5, 1.0, norm).numpy(),
            np.asarray(jcanny.gaussian_kernel_1d(5, 1.0, norm)), rtol=1e-6)
    k = canny.gaussian_kernel_1d(5, 1.0, normalize=False).numpy()
    np.testing.assert_allclose(
        k, np.exp(-0.5 * np.array([-2.0, -1.0, 0.0, 1.0, 2.0]) ** 2),
        rtol=1e-6)


def test_blur_matches_jax_and_preserves_constant():
    img = np.random.default_rng(0).uniform(0, 255, (2, 20, 24, 3)).astype(
        np.float32)
    for norm in (True, False):
        np.testing.assert_allclose(
            canny.gaussian_blur(torch.as_tensor(img), normalize=norm).numpy(),
            np.asarray(jcanny.gaussian_blur(jnp.asarray(img),
                                            normalize=norm)),
            atol=1e-3)
    flat = canny.gaussian_blur(torch.full((1, 16, 16, 3), 7.0)).numpy()
    np.testing.assert_allclose(flat[0, 4:-4, 4:-4], 7.0, atol=1e-4)


@pytest.mark.parametrize("shape,thresh", [((2, 40, 48, 3), 10.0),
                                          ((1, 48, 64, 3), 20.0),
                                          ((3, 32, 32), 5.0)])
def test_canny_matches_jax(shape, thresh):
    img = np.random.default_rng(len(shape)).uniform(0, 255, shape).astype(
        np.float32)
    got = canny.canny_edges(torch.as_tensor(img), low_threshold=thresh)
    ref = jcanny.canny_edges(jnp.asarray(img), low_threshold=thresh)
    np.testing.assert_allclose(got.blurred.numpy(), np.asarray(ref.blurred),
                               atol=1e-3)
    mag, rmag = got.grad_magnitude.numpy(), np.asarray(ref.grad_magnitude)
    np.testing.assert_allclose(mag, rmag, atol=1e-2)
    o, ro = got.grad_orientation.numpy(), np.asarray(ref.grad_orientation)
    assert (np.abs(o - ro) > 1e-3).mean() < 1e-3
    keep, rkeep = got.thin_edges.numpy() > 0, np.asarray(ref.thin_edges) > 0
    ties = _near_ties(rmag, 1e-3) | (np.abs(o - ro) > 1e-3)
    np.testing.assert_array_equal(keep[~ties], rkeep[~ties])
    assert (keep != rkeep).mean() < 1e-3
    thr, rthr = got.thresholded.numpy(), np.asarray(ref.thresholded)
    edge = np.abs(rmag - thresh) <= 1e-3
    ok = ~(ties | edge)
    np.testing.assert_allclose(thr[ok], rthr[ok], atol=1e-2)
    np.testing.assert_allclose(got.early_threshold.numpy()[~edge],
                               np.asarray(ref.early_threshold)[~edge],
                               atol=1e-2)


def test_reference_semantics_parity_rgb():
    """tests/test_canny.py's tuple parity against the torch oracle of the
    reference's net_canny.py, on the same image and tolerances."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (3, 40, 40)).astype(np.float32)
    blurred_t, mag_t, orient_t, thin_t, thr_t, early_t = (
        _torch_reference_canny(img, threshold=10.0))
    out = canny.canny_edges(torch.as_tensor(img.transpose(1, 2, 0))[None],
                            low_threshold=10.0)
    np.testing.assert_allclose(out.blurred[0].numpy(),
                               blurred_t.transpose(1, 2, 0), atol=1e-3)
    np.testing.assert_allclose(out.grad_magnitude[0].numpy(), mag_t,
                               atol=1e-2)
    np.testing.assert_allclose(out.grad_orientation[0].numpy(), orient_t,
                               atol=1e-3)
    np.testing.assert_array_equal(out.thin_edges[0].numpy() > 0, thin_t > 0)
    np.testing.assert_allclose(out.thin_edges[0].numpy(), thin_t, atol=1e-2)
    np.testing.assert_allclose(out.thresholded[0].numpy(), thr_t, atol=1e-2)
    np.testing.assert_allclose(out.early_threshold[0].numpy(), early_t,
                               atol=1e-2)


def test_canny_finds_square_edges_and_thins():
    out = canny.canny_edges(torch.as_tensor(make_square_image()),
                            low_threshold=10.0)
    thr = out.thresholded[0].numpy()
    assert thr.shape == (48, 48)
    assert thr[12, 12:36].max() > 0 or thr[11, 12:36].max() > 0
    assert thr[20:28, 20:28].max() == 0.0 and thr[:6, :6].max() == 0.0
    assert (out.thin_edges.numpy() <= out.grad_magnitude.numpy() + 1e-5).all()
    early = (out.early_threshold[0].numpy() > 0).sum()
    assert 0 < (thr > 0).sum() < early
    # against JAX: a flat-sided square gives exact magnitude ties along its
    # edges, where the strict NMS comparison follows the last bits
    ref = jcanny.canny_edges(jnp.asarray(make_square_image()),
                             low_threshold=10.0)
    ties = _near_ties(np.asarray(ref.grad_magnitude), 1e-3)[0]
    np.testing.assert_array_equal((thr > 0)[~ties],
                                  (np.asarray(ref.thresholded[0]) > 0)[~ties])


def test_orientation_rounded_and_shapes():
    img = np.random.default_rng(0).uniform(0, 255, (2, 32, 32, 3)).astype(
        np.float32)
    out = canny.canny_edges(torch.as_tensor(img))
    assert out.blurred.shape == (2, 32, 32, 3)
    assert out.grad_magnitude.shape == (2, 32, 32)
    o = out.grad_orientation.numpy()
    assert o.min() >= 0.0 and o.max() <= 360.0
    assert np.all(np.abs(o / 45.0 - np.round(o / 45.0)) < 1e-4)


def test_canny_differentiable_like_jax():
    """The magnitude sum's gradient to the image: finite, nonzero, and
    equal to JAX's within 1e-3 of its largest."""
    import jax

    img = make_square_image(32)
    x = torch.as_tensor(img).requires_grad_(True)
    canny.canny_edges(x, low_threshold=5.0).grad_magnitude.sum().backward()
    g = x.grad.numpy()
    jg = np.asarray(jax.grad(lambda a: jnp.sum(jcanny.canny_edges(
        a, low_threshold=5.0).grad_magnitude))(jnp.asarray(img)))
    assert np.all(np.isfinite(g)) and np.abs(g).sum() > 0
    np.testing.assert_allclose(g, jg, atol=1e-3 * np.abs(jg).max())

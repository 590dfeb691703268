"""The plain references against cases checked by hand."""

import math

import torch

from reference.depth import depth
from reference.soft import soft_alpha

K64 = torch.tensor([[64.0, 0.0, 32.0], [0.0, 64.0, 32.0], [0.0, 0.0, 1.0]])
EYE = torch.eye(3)[None]
ZERO = torch.zeros(1, 3)


def quad(z: float, size: float = 1.0):
    h = size / 2
    verts = torch.tensor([[-h, -h, z], [h, -h, z], [h, h, z], [-h, h, z]])
    return verts, torch.tensor([[0, 1, 2], [0, 2, 3]])


def test_depth_of_a_quad_facing_the_camera():
    # the quad spans u, v in [16, 48]: pixel centres 16.5 ... 47.5
    verts, faces = quad(2.0)
    d = depth(verts, faces, K64, EYE, ZERO, (64, 64))[0]
    assert int((d > 0).sum()) == 1024
    assert bool((d[16:48, 16:48] > 0).all())
    assert torch.allclose(d[d > 0], torch.full((1024,), 2.0), atol=1e-6)


def test_depth_is_perspective_correct_and_nearest_wins():
    # a plane tilted about x: z = 2 + y; the depth along the ray of pixel
    # row i is the ray's intersection with it
    verts = torch.tensor([[-2.0, -1.0, 1.0], [2.0, -1.0, 1.0],
                          [2.0, 1.0, 3.0], [-2.0, 1.0, 3.0]])
    faces = torch.tensor([[0, 1, 2], [0, 2, 3]])
    near, nf = quad(1.5, 0.25)                       # in front, small
    v = torch.cat([verts, near])
    f = torch.cat([faces, nf + 4])
    d = depth(v, f, K64, EYE, ZERO, (64, 64))[0]
    for i in (5, 20, 40, 50):
        yr = (i + 0.5 - 32.0) / 64.0                 # y / z along the ray
        want = 2.0 / (1.0 - yr)                      # z = 2 + yr z
        assert math.isclose(float(d[i, 5]), want, rel_tol=1e-5)
    assert float(d[32, 32]) == 1.5                   # the near quad wins


def test_soft_alpha_inside_outside_and_at_a_distance():
    verts, faces = quad(2.0)
    sigma = 1e-4
    a = soft_alpha(verts, faces, K64, EYE, ZERO, (64, 64), sigma)[0]
    assert float(a[20, 26]) == 1.0                   # deep inside
    assert float(a[2, 2]) == 0.0                     # far outside: +0.0
    # pixel (row 32, col 50): centre u = 50.5, 2.5 px right of the edge at
    # u = 48; raster units are 32 px; only the right-hand face is near
    d2 = (2.5 / 32.0) ** 2
    want = 1.0 - math.exp(-math.log1p(math.exp(-d2 / sigma)))
    assert math.isclose(float(a[32, 50]), want, rel_tol=1e-4, abs_tol=1e-7)


def test_soft_gradient_matches_finite_differences():
    torch.manual_seed(0)
    verts, faces = quad(2.0)
    verts = (verts + 0.02 * torch.randn(4, 3)).double()
    K, R, t = K64.double(), EYE.double(), ZERO.double()
    sigma = 1e-3
    _, g = soft_alpha(verts, faces, K, R, t, (64, 64), sigma, grad=True,
                      dtype=torch.float64)
    direction = torch.randn(4, 3, dtype=torch.float64)
    eps = 1e-6

    def total(v):
        out = torch.zeros((), dtype=torch.float64)
        a = soft_alpha(v, faces, K, R, t, (64, 64), sigma,
                       dtype=torch.float64)
        return out + a.double().sum()

    fd = (total(verts + eps * direction) - total(verts - eps * direction)) \
        / (2 * eps)
    assert math.isclose(float((g.double() * direction).sum()), float(fd),
                        rel_tol=1e-3)

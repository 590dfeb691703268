"""The multi-card layer (torch_renderer_tpu_torch.parallel) on the CPU: every
case of tests/test_parallel.py, run in one world of 8 gloo ranks (spawned
once for the module by parallel.launch.run_ranks; the cases are in
tests/torch_parallel_cases.py) and held against the JAX package's
single-device results at that file's tolerances, and against the port's
single-rank calls.

The JAX file compares its sharded calls with its own single-device calls.
Where the two packages draw from different random streams (the pose
search) or another file holds the port's single-rank call to the JAX
package (the COCO generator, tests/test_torch_datagen.py; the bench step,
tests/test_torch_bench.py; the point renderers,
tests/test_torch_point_render.py), the sharded call is held against the
port's single-rank call at the JAX file's tolerance.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
from torch_renderer_tpu.cameras.perspective import PerspectiveCamera as JCam
from torch_renderer_tpu.rasterize.soft import (
    soft_silhouette_streaming as jstreaming,
)
from torch_renderer_tpu.structures.meshes import Meshes as JMeshes
from torch_renderer_tpu_torch.parallel import make_mesh
from torch_renderer_tpu_torch.parallel.launch import run_ranks
from torch_renderer_tpu_torch.rasterize.soft import soft_silhouette_streaming


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _jax_scene(batch):
    from torch_renderer_tpu_torch.ops.icosphere import icosphere

    verts, faces = icosphere(1)
    meshes = JMeshes.from_single(verts, faces).extend(batch)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (batch, 3, 3))
    t = np.tile(np.array([0.0, 0.0, 3.0], np.float32), (batch, 1))
    return meshes, JCam.from_K(cases.intrinsics(), cases.IMAGE, R=R, t=t)


@pytest.fixture(scope="module")
def problems():
    """The inputs the ranks take: tests/test_parallel.py's registration
    batches (B=5 with a 0.3 crop, B=3), made by the port from a seeded
    generator, and its pose-search cloud and target."""
    from torch_renderer_tpu_torch.opt.registration import (
        RegisterDataConfig,
        create_register_data,
    )
    from torch_renderer_tpu_torch.transforms.so3 import (
        euler_angles_to_matrix,
        transform_points,
    )

    gen = torch.Generator().manual_seed(6)
    base = torch.randn((64, 3), generator=gen) * 0.2
    d5 = create_register_data(gen, base, RegisterDataConfig(
        n_objects=5, crop_fraction=0.3))
    d3 = create_register_data(gen, base[:48],
                              RegisterDataConfig(n_objects=3))
    ref = torch.randn((96, 3), generator=gen) * 0.2
    gt_R = euler_angles_to_matrix(torch.tensor([0.3, -0.5, 0.9]), "XYZ")
    target = transform_points(gt_R, torch.tensor([0.15, -0.05, 0.2]), ref)
    return {"d5": {k: _np(v) for k, v in d5.items()},
            "d3": {k: _np(v) for k, v in d3.items()},
            "ref": _np(ref), "target": _np(target)}


@pytest.fixture(scope="module")
def ranks(problems, tmp_path_factory):
    """Every rank's results of torch_parallel_cases.run_all (8 gloo ranks,
    one torch thread each), and the datagen output directories."""
    root = tmp_path_factory.mktemp("coco_ranks")
    dirs = [str(root / f"rank{r}") for r in range(cases.WORLD)]
    p = problems
    out = run_ranks(cases.run_all, cases.WORLD, "gloo", p["d5"], p["d3"],
                    p["ref"], p["target"], dirs, threads=1, timeout=300)
    return out, dirs


@pytest.fixture(scope="module")
def r0(ranks):
    return ranks[0][0]


@pytest.fixture(scope="module")
def want():
    """The JAX package's single-device streaming silhouette of the scene."""
    return np.asarray(jax.jit(jstreaming)(*_jax_scene(cases.B)))


@pytest.fixture(scope="module")
def jax_grad():
    """The JAX package's vertex gradient of the sum of that silhouette."""
    meshes, cam = _jax_scene(cases.B)

    def loss(v):
        return jnp.sum(jstreaming(meshes.update_padded(v), cam))

    return np.asarray(jax.jit(jax.grad(loss))(meshes.verts))


# -- the face- and data-sharded silhouette ----------------------------------

def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((1, 1))


def test_mesh_shape_and_type_checks(ranks):
    for r in ranks[0]:
        assert r["mesh_shape"] == (4, 2)
        assert r["bad_shape"].startswith("ValueError") \
            and "device count 8" in r["bad_shape"]
        assert r["not_a_mesh"].startswith("TypeError")


def test_sharded_silhouette_matches_streaming(r0, want):
    np.testing.assert_allclose(_np(r0["sil"]["streaming"]), want, atol=2e-5)


def test_every_rank_holds_the_whole_result(ranks):
    first = ranks[0][0]["sil"]
    for r in ranks[0][1:]:
        for k in ("streaming", "pallas", "grad"):
            np.testing.assert_array_equal(_np(r["sil"][k]),
                                          _np(first[k]), err_msg=k)


def test_sharded_silhouette_gradients_match(r0, jax_grad):
    np.testing.assert_allclose(r0["sil"]["grad"], jax_grad, atol=1e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("impl", ["streaming", "pallas"])
def test_sharded_gradient_is_the_single_rank_gradient(r0, impl):
    """Not m (= 2) times it: the all_reduce over 'model' passes the
    gradient through, and the inputs' partial gradients sum over the
    ranks once."""
    meshes, cam = cases.scene()
    single = cases.vertex_grad(meshes, lambda m: soft_silhouette_streaming(
        m, cam, pixel_chunk=512, face_chunk=16))
    got = r0["sil"]["grad" if impl == "streaming" else "pallas_grad"]
    scale = np.abs(single).max()
    np.testing.assert_allclose(got, single, rtol=0,
                               atol=(1e-5 if impl == "streaming" else 1e-4)
                               * scale)


def test_sharded_pose_step_decreases_loss(r0):
    losses = r0["pose_step"]["losses"]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    trail = _np(r0["pose_step"]["t_trail"])
    assert np.abs(trail[-1] - trail[0]).max() > 0


def test_capture_true_under_gloo_raises(r0):
    msg = r0["pose_step"]["capture_true"]
    assert msg is not None and msg.startswith("ValueError") \
        and "NCCL" in msg


def test_data_parallel_matches_single_device(r0, want):
    np.testing.assert_allclose(_np(r0["sil"]["data_parallel"]), want,
                               atol=2e-5)


@pytest.mark.parametrize("case", ["pallas", "pallas_active",
                                  "pallas_packed"])
def test_sharded_pallas_matches_streaming(r0, want, case):
    """The face-sharded kernel route (faces_per_tile 40 = 80 faces / 2
    ranks), with per-rank active-tile compaction and the packed layout
    (here the kernels' plain versions)."""
    np.testing.assert_allclose(_np(r0["sil"][case]), want, atol=1e-4)


@pytest.mark.parametrize("shape", ["2x4", "8x1", "1x8"])
def test_sharded_silhouette_other_mesh_shapes(r0, want, shape):
    """Pure face, pure data (B=4 over 8 ranks: padded) and tall face
    splits."""
    np.testing.assert_allclose(_np(r0[f"sil_{shape}"]), want, atol=2e-5)


def test_sharded_silhouette_uneven_batch(r0, want, jax_grad):
    """B=3 over a 4-way data axis: padded, cut back, and the gradient
    flows only to the real rows (the scene's rows are copies of one view,
    so the B=3 references are the first rows of the B=4 ones)."""
    got = _np(r0["sil"]["uneven"])
    assert got.shape == (3, *cases.IMAGE)
    np.testing.assert_allclose(got, want[:3], atol=2e-5)
    np.testing.assert_allclose(r0["sil"]["uneven_grad"], jax_grad[:3],
                               atol=1e-3, rtol=1e-3)


# -- sharded pose search -----------------------------------------------------

def _search(config, **kw):
    from torch_renderer_tpu_torch.opt.pose_search import (
        GMMPoseSearch,
        PoseSearchConfig,
    )

    return lambda ref: GMMPoseSearch(torch.as_tensor(ref),
                                     PoseSearchConfig(**config, **kw))


def test_sharded_pose_search_matches_single(r0, problems):
    from torch_renderer_tpu.opt.pose_search import chamfer_scores

    p = problems
    search = _search(dict(n_hypotheses=64, n_elite=16, n_iters=3))(p["ref"])
    plain = search.search(torch.Generator().manual_seed(7),
                          torch.as_tensor(p["target"]))
    sharded = r0["search"]["search"]
    for name in ("pose6d", "score", "best_history"):
        np.testing.assert_allclose(_np(plain[name]), _np(sharded[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert float(sharded["score"]) <= float(sharded["best_history"][0])
    # the JAX package scores the found pose the same
    theirs = chamfer_scores(jnp.asarray(p["ref"]), jnp.asarray(p["target"]),
                            jnp.asarray(_np(sharded["pose6d"]))[None])
    np.testing.assert_allclose(float(theirs[0]), float(sharded["score"]),
                               rtol=1e-5, atol=1e-6)


def test_sharded_pose_search_rejects_uneven_hypotheses(r0):
    msg = r0["search"]["uneven_hypotheses"]
    assert msg is not None and msg.startswith("ValueError") and "data" in msg


def test_sharded_search_batch_pads_uneven(r0, problems):
    p = problems
    target = torch.as_tensor(p["target"])
    eye = torch.eye(3)
    from torch_renderer_tpu_torch.transforms.so3 import transform_points

    targets = torch.stack([
        target, transform_points(eye, torch.tensor([0.1, 0.0, -0.1]), target),
        transform_points(eye, torch.tensor([-0.2, 0.1, 0.0]), target)])
    search = _search(dict(n_hypotheses=32, n_elite=8, n_iters=2))(p["ref"])
    plain = search.search_batch(torch.Generator().manual_seed(11), targets)
    sharded = r0["search"]["batch"]
    assert sharded["pose6d"].shape == (3, 6)
    for name in ("score", "pose6d", "best_history", "iter_scores"):
        np.testing.assert_allclose(_np(plain[name]), _np(sharded[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


# -- sharded registration ----------------------------------------------------

def _port_register(data, **kw):
    from torch_renderer_tpu_torch.opt.registration import register_batch

    return register_batch({k: torch.as_tensor(v) for k, v in data.items()},
                          **kw)


def test_sharded_icp_registration_matches_single(r0, problems):
    """B=5 on a 4-way data axis (padded), against the JAX package's
    single-device ICP (at tests/test_torch_icp.py's 1e-4) and the port's
    single-rank ICP (at tests/test_parallel.py's tolerance), every
    field."""
    from torch_renderer_tpu.opt.registration import register_batch

    d5 = problems["d5"]
    sharded = r0["icp"]["uneven"]
    theirs = register_batch({k: jnp.asarray(v) for k, v in d5.items()},
                            max_iterations=12)
    ours = _port_register(d5, max_iterations=12)
    for name, got, jx, pt in (
            ("R", sharded.RTs.R, theirs.RTs.R, ours.RTs.R),
            ("t", sharded.RTs.t, theirs.RTs.t, ours.RTs.t),
            ("rmse", sharded.rmse, theirs.rmse, ours.rmse)):
        np.testing.assert_allclose(_np(got), np.asarray(jx), atol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(_np(got), _np(pt), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    for name in ("converged", "Xt", "t_history", "rmse_history"):
        np.testing.assert_allclose(_np(getattr(sharded, name)),
                                   _np(getattr(ours, name)), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_sharded_icp_uneven_with_init_transform(r0, problems):
    from torch_renderer_tpu.ops.icp import SimilarityTransform as JSim
    from torch_renderer_tpu.opt.registration import register_batch
    from torch_renderer_tpu_torch.ops.icp import SimilarityTransform

    d3 = problems["d3"]
    jinit = JSim(R=jnp.broadcast_to(jnp.eye(3), (3, 3, 3)),
                 t=jnp.zeros((3, 3)), s=jnp.ones((3,)))
    theirs = register_batch({k: jnp.asarray(v) for k, v in d3.items()},
                            max_iterations=8, init_transform=jinit)
    init = SimilarityTransform(R=torch.eye(3).expand(3, 3, 3),
                               t=torch.zeros((3, 3)), s=torch.ones(3))
    ours = _port_register(d3, max_iterations=8, init_transform=init)
    got = _np(r0["icp"]["init"].RTs.t)
    np.testing.assert_allclose(got, np.asarray(theirs.RTs.t), atol=1e-4)
    np.testing.assert_allclose(got, _np(ours.RTs.t), rtol=1e-5, atol=1e-6)


# -- sharded data generation, bench, points and fit --------------------------

def test_sharded_datagen_matches_single(r0):
    """View-axis sharding over 'data' equals the single-rank generator bit
    for bit (packed u8/u16/i8 outputs), with view_chunk rounded up 3 ->
    4."""
    assert r0["datagen"]["view_chunk"] == 4
    single = cases.datagen_render()
    for k in ("rgb", "depth", "segmentation", "normals"):
        np.testing.assert_array_equal(single[k], r0["datagen"][k],
                                      err_msg=k)


def test_sharded_datagen_rank_zero_writes(ranks):
    _, dirs = ranks
    written = [d for d in dirs if os.path.exists(d)]
    assert written == dirs[:1]
    assert os.path.exists(os.path.join(dirs[0], "annotations.json"))
    assert len(os.listdir(os.path.join(dirs[0], "images"))) == 6


def test_bench_step_sharded_matches_single(r0):
    """The bench twin's multi-card branch (1 view per rank over an 8-rank
    data mesh, 3 chained steps at 64^2, level 1) against one rank on the
    whole batch, within 1e-6 (tests/test_torch_bench.py holds that step
    to the JAX package's scan)."""
    from torch_renderer_tpu_torch import bench as tbench

    sharded = _np(r0["bench"]["verts"])
    assert sharded.shape[0] == 8
    meshes, cam = tbench.scene(8, 64, 1, "cpu")
    step, _ = tbench.make_step(meshes, cam, capture=False)
    v = meshes.verts
    for _ in range(3):
        v, _ = step(v)
    np.testing.assert_allclose(sharded, _np(v), rtol=0, atol=1e-6)
    assert np.abs(sharded - _np(meshes.verts)).max() > 0


@pytest.mark.parametrize("name", ["alpha", "pulsar"])
def test_sharded_point_render_matches_single(r0, name):
    """render_points_sharded (B=3 over 8 data ranks: padded; the sphere
    renderer's per-point radii) against the port's single-rank render
    within 1e-5 on every pixel (tests/test_parallel.py allows 1% of pixels
    flipped at splat rims against its single-device render; the port's
    single-rank renderers are held to the JAX package's in
    tests/test_torch_point_render.py)."""
    from torch_renderer_tpu_torch.structures.pointclouds import Pointclouds

    pts, feats, R, t = cases.point_scene()
    got = _np(r0["points"][name])
    assert got.shape[0] == 3
    pcl = Pointclouds(points=torch.as_tensor(pts),
                      num_points=torch.full((3,), 300),
                      features=torch.as_tensor(feats))
    single = _np(cases.point_renderers()[name].render(pcl, R, t))
    assert np.abs(single).max() > 0
    np.testing.assert_allclose(got, single, atol=1e-5)


def test_data_parallel_fit_matches_single(r0):
    """data_parallel_fit over the 4-way data axis (one item a rank) gives
    the single-rank fit's history within 1e-4 and its parameters."""
    fitter, meshes, refs, params0 = cases.pose_fit_problem()
    params, hist = fitter.fit(meshes, refs, params0, 6)
    got = r0["fit"]["history"]
    assert sorted(got) == sorted(hist)
    for k in hist:
        np.testing.assert_allclose(_np(got[k]), _np(hist[k]), atol=1e-4,
                                   err_msg=k)
    for k in params:
        np.testing.assert_allclose(_np(r0["fit"]["params"][k]),
                                   _np(params[k]), atol=1e-6, err_msg=k)

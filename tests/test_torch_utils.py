"""The port's utilities (torch_renderer_tpu_torch.utils, the open3d oracle of
baselines, check_budgets="checkify"): the cases of tests/test_utils.py,
tests/test_plotting.py::test_image_grid_layout and the checkify and
process-default cases of tests/test_budget_checks.py, and the checkpoint
format held against the JAX package's save_checkpoint."""

import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_renderer_tpu_torch.cameras.perspective import PerspectiveCamera
from torch_renderer_tpu_torch.ops.icosphere import icosphere
from torch_renderer_tpu_torch.rasterize import binning
from torch_renderer_tpu_torch.rasterize.raster import (
    RasterizationSettings,
    rasterize_meshes,
)
from torch_renderer_tpu_torch.structures.meshes import Meshes
from torch_renderer_tpu_torch.utils.checkpoint import (
    export_mesh_snapshot,
    load_checkpoint,
    load_checkpoint_dcp,
    save_checkpoint,
    save_checkpoint_dcp,
)
from torch_renderer_tpu_torch.utils.debug import (
    anomaly_detection,
    checked,
    checked_budgets,
)
from torch_renderer_tpu_torch.utils.metrics import MetricLogger

IMG = 48
B = 2


def _adam_problem():
    target = torch.tensor([0.5, -1.0, 2.0, 0.25])

    def fresh():
        p = {"t": torch.zeros(3, requires_grad=True),
             "quat": torch.tensor([1.0, 0.0, 0.0, 0.0], requires_grad=True)}
        return p, torch.optim.Adam(list(p.values()), lr=1e-2)

    def step(p, opt):
        opt.zero_grad()
        loss = ((torch.cat([p["t"], p["quat"][:1]]) - target) ** 2).sum() \
            + (p["quat"] ** 2).sum()
        loss.backward()
        opt.step()

    return fresh, step


def test_checkpoint_roundtrip_params_and_optstate(tmp_path):
    """Params and an Adam state saved at step 7 restore into fresh ones, and
    the resumed fit equals the unbroken one step for step."""
    fresh, step = _adam_problem()
    params, opt = fresh()
    for _ in range(7):
        step(params, opt)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, (params, opt.state_dict()), step=7)

    rp, ropt = fresh()
    step(rp, ropt)                 # a state of the right structure
    (loaded, state), at = load_checkpoint(path, (rp, ropt.state_dict()))
    assert at == 7
    with torch.no_grad():
        for k in rp:
            rp[k].copy_(loaded[k])
    ropt.load_state_dict(state)
    torch.testing.assert_close(rp["t"], params["t"], rtol=0, atol=0)
    for _ in range(5):
        step(params, opt)
        step(rp, ropt)
    for k in params:
        torch.testing.assert_close(rp[k], params[k], rtol=0, atol=0)


def test_checkpoint_reads_the_jax_format(tmp_path):
    """A tree saved by the JAX package's save_checkpoint (keys leaf_i in
    flattening order, __step__) loads into the port's tree."""
    from torch_renderer_tpu.utils.checkpoint import save_checkpoint as jsave

    path = str(tmp_path / "jax_ckpt")
    tree = {"t": jnp.asarray([1.0, 2.0, 3.0]),
            "quat": jnp.asarray([1.0, 0.0, 0.0, 0.0]),
            "w": jnp.arange(6.0).reshape(2, 3)}
    jsave(path, tree, step=3)
    like = {"t": torch.zeros(3), "quat": torch.zeros(4),
            "w": torch.zeros(2, 3)}
    back, step = load_checkpoint(path, like)
    assert step == 3
    for k in tree:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(tree[k]))
        assert back[k].dtype == torch.float32


def test_mesh_snapshot_export(tmp_path):
    from torch_renderer_tpu_torch.io.obj import load_obj

    verts, faces = icosphere(0)
    m = Meshes.from_single(verts, faces, device="cpu")
    path = str(tmp_path / "snap.obj")
    export_mesh_snapshot(path, m)
    back = load_obj(path, load_textures=False)
    np.testing.assert_allclose(np.asarray(back.verts), verts, atol=1e-5)


def test_checked_catches_nan():
    f = checked(torch.log)
    assert np.isfinite(float(f(torch.tensor(2.0))))
    with pytest.raises(FloatingPointError, match="NaN"):
        f(torch.tensor(-1.0))


def test_anomaly_detection_restores_flags():
    before = torch.is_anomaly_enabled()
    with anomaly_detection():
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="Inf"):
            torch.tensor([1.0, 0.0]).reciprocal()
    assert torch.is_anomaly_enabled() == before
    torch.tensor([0.0]).reciprocal()   # no check outside the block


def test_dcp_checkpoint_roundtrip(tmp_path):
    """torch.distributed.checkpoint in place of the JAX package's orbax
    directory layout."""
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)}
    path = str(tmp_path / "ck_dcp")
    save_checkpoint_dcp(path, tree)
    back = load_checkpoint_dcp(path, {"w": torch.zeros(2, 3),
                                      "b": torch.zeros(3)})
    for k in tree:
        assert torch.equal(back[k], tree[k])


def test_metric_logger_jsonl(tmp_path, capsys):
    path = tmp_path / "m" / "log.jsonl"
    log = MetricLogger(str(path), print_every=2)
    log.log_history({"loss": torch.tensor([3.0, 2.0, 1.0]),
                     "iou": np.array([0.1, 0.5, 0.9])}, start_step=10)
    png = log.log_image("sil", torch.rand(8, 8), step=3,
                        out_dir=str(tmp_path / "img"))
    log.close()
    rows = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["step"] for r in rows] == [10, 11, 12]
    assert [r["loss"] for r in rows] == [3.0, 2.0, 1.0]
    assert "[10] loss=3" in capsys.readouterr().out
    assert png.endswith("sil_000003.png")


def test_image_grid_layout():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from torch_renderer_tpu_torch.utils.plotting import image_grid

    imgs = torch.rand(6, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    fig = image_grid(imgs, rows=2, cols=3)
    assert len(fig.axes) == 6
    fig2 = image_grid(imgs.numpy())   # auto grid
    assert len(fig2.axes) >= 6
    plt.close("all")


def test_open3d_oracle_is_import_gated():
    from torch_renderer_tpu_torch import baselines

    if baselines.open3d_available():
        pytest.skip("open3d is installed; the gate is not exercised")
    with pytest.raises(ImportError, match="icp_cpu_reference"):
        baselines.open3d_registration_icp(np.zeros((4, 3)), np.zeros((4, 3)))


# -- check_budgets="checkify" --------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    verts, faces = icosphere(2)       # 320 faces: enough to overflow
    meshes = Meshes.from_single(verts, faces, device="cpu").extend(B)
    f = 0.8 * IMG
    K = np.array([[f, 0, IMG / 2], [0, f, IMG / 2], [0, 0, 1]], np.float32)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3))
    t = np.tile(np.array([0.0, 0.0, 2.5], np.float32), (B, 1))
    return meshes, PerspectiveCamera.from_K(K, (IMG, IMG), R=R, t=t,
                                            device="cpu")


def _settings(max_faces, mode):
    return RasterizationSettings(image_size=(IMG, IMG), bin_size=16,
                                 max_faces_per_bin=max_faces,
                                 check_budgets=mode)


def test_checkify_mode_raises(scene):
    meshes, cam = scene
    fn = checked_budgets(
        lambda m: rasterize_meshes(m, cam, _settings(8, "checkify")).zbuf)
    with pytest.raises(binning.BudgetOverflowError,
                       match="max_faces_per_bin"):
        fn(meshes)
    # outside the wrapper the mode raises at once, as unwrapped checkify
    with pytest.raises(RuntimeError, match="checked_budgets"):
        rasterize_meshes(meshes, cam, _settings(8, "checkify"))


def test_checkify_mode_silent_without_overflow(scene):
    meshes, cam = scene
    fn = checked_budgets(
        lambda m: rasterize_meshes(m, cam, _settings(320, "checkify")).zbuf)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = fn(meshes)
    assert out.shape[:3] == (B, IMG, IMG)


def test_checkify_process_default(scene):
    """check_budgets unset falls back to the process default, which
    accepts "checkify" as the JAX package's does."""
    meshes, cam = scene
    binning.set_budget_check_default("checkify")
    try:
        assert binning.resolve_budget_check(None) == "checkify"
        fn = checked_budgets(
            lambda m: rasterize_meshes(m, cam, _settings(8, None)).zbuf)
        with pytest.raises(binning.BudgetOverflowError,
                           match="max_faces_per_bin"):
            fn(meshes)
    finally:
        binning.set_budget_check_default(None)
    with pytest.raises(ValueError):
        binning.set_budget_check_default("loud")

"""The port's data generator (datagen/texgen.py, datagen/coco.py and the
app apps/coco_data_generator.py) against the JAX package's on the CPU.

The same np.random.default_rng(seed) goes into both generators at 48x64,
2 views: they must draw the same scenes (object categories, poses,
poses.json), the same cameras (R within 1e-6, t within 1e-6: the look-at
rotation is float32 arithmetic in both) and leave the generator in the
same state. The packed outputs: rgb within 1 level, depth within 1 mm,
normals within 1, seg equal except at selection-depth ties on under 0.1%
of covered pixels (the count is reported); edges within 1 level except
where the seg or rgb differs. Annotations (bbox, area, RLE) must be equal
wherever the two seg maps give the object the same mask. texgen is a numpy
copy and must be equal.

The three configurations: the app's defaults (random materials, rest
placement); textured materials in a room with visibility-checked cameras
and edge maps; distractors with uniform colors and no normals pass.
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_renderer_tpu.ops.canny  # noqa: F401  (see _jax_generator)
from torch_renderer_tpu.datagen import coco as jcoco
from torch_renderer_tpu.datagen import texgen as jtex
from torch_renderer_tpu.ops.icosphere import cube, icosphere
from torch_renderer_tpu_torch.datagen import coco, texgen
from torch_renderer_tpu_torch.rasterize import binning

SIZE = (48, 64)
CONFIGS = {
    "defaults": dict(),
    "texture_room": dict(material_mode="texture", room=True,
                         min_visible_px=60, edge_maps=True),
    "distractors": dict(material_mode="uniform", objects_per_scene=(2, 3),
                        distractors_per_scene=(1, 2), normal_maps=False,
                        min_visibility=0.0005),
}
SEEDS = {"defaults": 3, "texture_room": 3, "distractors": 5}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _libraries(mod, name):
    lib = mod.ObjectLibrary.primitives()
    dlib = mod.ObjectLibrary.primitives(2) if name == "distractors" else None
    return lib, dlib


def _jax_generator(name):
    """The JAX generator. torch_renderer_tpu.ops.canny is imported at this
    file's top: imported first inside the jitted chunk render (as
    coco.py:544 does), its module constant becomes a tracer that the next
    trace of the chunk (after a bin budget grows) trips on."""
    lib, dlib = _libraries(jcoco, name)
    cfg = jcoco.DataGenConfig(image_size=SIZE, views_per_scene=2,
                              view_chunk=2, **CONFIGS[name])
    return jcoco.COCODataGenerator(lib, cfg, distractor_library=dlib)


def _port_generator(name):
    lib, dlib = _libraries(coco, name)
    cfg = coco.DataGenConfig(image_size=SIZE, views_per_scene=2,
                             view_chunk=2, **CONFIGS[name])
    return coco.COCODataGenerator(lib, cfg, distractor_library=dlib,
                                  device="cpu")


@pytest.fixture(scope="module", params=list(CONFIGS))
def runs(request, tmp_path_factory):
    """One configuration through both generators: a sampled and rendered
    scene each, and a generated one-scene dataset each."""
    name = request.param
    seed = SEEDS[name]
    out = {"name": name}
    for tag, make in (("jax", _jax_generator), ("port", _port_generator)):
        gen = make(name)
        rng = np.random.default_rng(seed)
        scene, poses = gen.sample_scene(rng)
        rendered = gen.render_scene(scene, rng)
        d = tmp_path_factory.mktemp(f"{name}_{tag}")
        cocod = gen.generate(str(d), n_scenes=1,
                             rng=np.random.default_rng(seed))
        out[tag] = {"gen": gen, "scene": scene, "poses": poses,
                    "rendered": rendered, "next": rng.uniform(),
                    "dir": d, "coco": cocod}
    binning.set_budget_check_default(None)
    return out


def test_same_scene_draws(runs):
    j, p = runs["jax"], runs["port"]
    assert p["next"] == j["next"]       # the rng consumed identically
    assert len(p["poses"]) == len(j["poses"]) > 0
    for a, b in zip(p["poses"], j["poses"]):
        assert (a["category_id"], a["name"]) == (b["category_id"], b["name"])
        np.testing.assert_allclose(a["R"], b["R"], atol=1e-6)
        np.testing.assert_allclose(a["t"], b["t"], atol=1e-6)
    np.testing.assert_array_equal(p["scene"].object_categories,
                                  j["scene"].object_categories)
    assert p["scene"].n_annotated == j["scene"].n_annotated
    np.testing.assert_allclose(p["scene"].meshes.verts.numpy(),
                               np.asarray(j["scene"].meshes.verts), atol=1e-6)
    np.testing.assert_array_equal(p["scene"].face_to_object.numpy(),
                                  np.asarray(j["scene"].face_to_object))
    tex, jtex_ = p["scene"].meshes.textures, j["scene"].meshes.textures
    assert type(tex).__name__ == type(jtex_).__name__
    if hasattr(tex, "maps"):
        np.testing.assert_array_equal(tex.maps.numpy(),
                                      np.asarray(jtex_.maps))
        np.testing.assert_allclose(tex.verts_uvs.numpy(),
                                   np.asarray(jtex_.verts_uvs), atol=1e-7)
    else:
        np.testing.assert_allclose(tex.verts_features.numpy(),
                                   np.asarray(jtex_.verts_features),
                                   atol=1e-6)
    pr, jr = p["rendered"], j["rendered"]
    np.testing.assert_allclose(pr["R"], jr["R"], atol=1e-6)
    np.testing.assert_allclose(pr["t"], jr["t"], atol=1e-6)
    np.testing.assert_array_equal(pr["K"], jr["K"])
    with open(p["dir"] / "poses.json") as f, open(j["dir"] / "poses.json") as g:
        pp, jp = json.load(f), json.load(g)
    assert len(pp) == len(jp) == 2
    for a, b in zip(pp, jp):
        assert a["image_id"] == b["image_id"]
        np.testing.assert_allclose(a["cam_R"], b["cam_R"], atol=1e-6)
        np.testing.assert_allclose(a["cam_t"], b["cam_t"], atol=1e-6)
        assert a["K"] == b["K"]
        assert [o["category_id"] for o in a["objects"]] == \
            [o["category_id"] for o in b["objects"]]
        for oa, ob in zip(a["objects"], b["objects"]):
            np.testing.assert_allclose(oa["R"], ob["R"], atol=1e-6)
            np.testing.assert_allclose(oa["t"], ob["t"], atol=1e-6)


def _seg_diff(p, j):
    """(pixels whose seg differs, covered pixels)."""
    ps, js = p["segmentation"], j["segmentation"]
    return int((ps != js).sum()), int(((ps != 255) | (js != 255)).sum())


def test_packed_outputs_match(runs):
    pr, jr = runs["port"]["rendered"], runs["jax"]["rendered"]
    cfg = CONFIGS[runs["name"]]
    names = ["rgb", "depth", "segmentation"]
    if cfg.get("normal_maps", True):
        names.append("normals")
    else:
        assert pr["normals"] is None and jr["normals"] is None
    if cfg.get("edge_maps"):
        names.append("edges")
    for n in names:
        assert pr[n].dtype == np.asarray(jr[n]).dtype, n
        assert pr[n].shape == np.asarray(jr[n]).shape, n
    assert pr["packed"] and jr["packed"]
    diff, covered = _seg_diff(pr, jr)
    print(f"[{runs['name']}] seg differs on {diff} of {covered} covered "
          "pixels")
    assert diff <= 1e-3 * covered
    same = (pr["segmentation"] == jr["segmentation"])
    i = lambda a: np.asarray(a).astype(np.int64)  # noqa: E731
    assert np.abs(i(pr["rgb"]) - i(jr["rgb"]))[same].max() <= 1
    assert np.abs(i(pr["depth"]) - i(jr["depth"]))[same].max() <= 1
    if "normals" in names:
        assert np.abs(i(pr["normals"]) - i(jr["normals"]))[same].max() <= 1
    if "edges" in names:
        # an edge is a thresholded local maximum: a 1-level rgb step moves
        # it, so edges are held where the rgb equals JAX's in the window
        e = np.abs(i(pr["edges"]) - i(jr["edges"]))
        rgb_same = (i(pr["rgb"]) == i(jr["rgb"])).all(-1)
        assert (e[rgb_same] > 1).mean() < 1e-2
        assert (pr["edges"] > 0).sum() > 10


def _decode_rle(rle):
    h, w = rle["size"]
    flat = np.zeros(h * w, bool)
    pos, val = 0, False
    for run in rle["counts"]:
        if val:
            flat[pos:pos + run] = True
        pos += run
        val = not val
    assert pos == h * w
    return flat.reshape((w, h)).T


def test_annotations_match(runs):
    p, j = runs["port"], runs["jax"]
    pc, jc = p["coco"], j["coco"]
    assert pc["categories"] == jc["categories"]
    assert pc["images"] == jc["images"]
    assert pc.get("info") == jc.get("info")
    for d in (p["dir"], j["dir"]):
        assert len(list((d / "images").glob("*.png"))) == 2
    pa = {(a["image_id"], a["category_id"], a["bbox"][0], a["bbox"][1]): a
          for a in pc["annotations"]}
    ja = {(a["image_id"], a["category_id"], a["bbox"][0], a["bbox"][1]): a
          for a in jc["annotations"]}
    by_img = {im["id"]: im for im in pc["images"]}
    compared = 0
    for img_id, im in by_img.items():
        stem = os.path.basename(im["file_name"]).replace(".png", "_seg.npy")
        ps, js = np.load(p["dir"] / "aux" / stem), np.load(j["dir"] / "aux" /
                                                           stem)
        for o in range(len(p["coco"]["categories"]) + 3):
            if not np.array_equal(ps == o, js == o):
                continue            # a tie moved a pixel of this object
            mine = [a for k, a in pa.items() if k[0] == img_id
                    and np.array_equal(_decode_rle(a["segmentation"]),
                                       ps == o)]
            theirs = [a for k, a in ja.items() if k[0] == img_id
                      and np.array_equal(_decode_rle(a["segmentation"]),
                                         js == o)]
            assert len(mine) == len(theirs)
            for a, b in zip(mine, theirs):
                assert (a["bbox"], a["area"], a["segmentation"],
                        a["category_id"]) == \
                    (b["bbox"], b["area"], b["segmentation"],
                     b["category_id"])
                compared += 1
    assert compared > 0
    if CONFIGS[runs["name"]].get("min_visible_px"):
        floor = CONFIGS[runs["name"]]["min_visible_px"]
        assert all(a["area"] >= floor for a in pc["annotations"])
    for a in pc["annotations"]:
        assert sum(a["segmentation"]["counts"]) == SIZE[0] * SIZE[1]


def test_written_files(runs):
    d = runs["port"]["dir"]
    with open(d / "annotations.json") as f:
        assert json.load(f) == json.loads(json.dumps(runs["port"]["coco"]))
    aux = sorted(x.name for x in (d / "aux").iterdir())
    want_normals = CONFIGS[runs["name"]].get("normal_maps", True)
    assert any(x.endswith("_depth.npy") for x in aux)
    assert any(x.endswith("_normals.npy") for x in aux) == want_normals
    seg = np.load(d / "aux" / "scene0000_view000_seg.npy")
    assert seg.dtype == np.uint8 and seg.shape == SIZE


# -- texgen ------------------------------------------------------------------

def test_texgen_matches_jax():
    for i, fam in enumerate(texgen._FAMILIES):
        a = fam(np.random.default_rng(i), 64)
        b = jtex._FAMILIES[i](np.random.default_rng(i), 64)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.float32 and a.min() >= 0 and a.max() <= 1
        assert a.std() > 0.01
    np.testing.assert_array_equal(
        texgen.random_texture(np.random.default_rng(7), 32),
        jtex.random_texture(np.random.default_rng(7), 32))
    sv, _ = icosphere(2)
    uv = texgen.planar_uvs(np.random.default_rng(0), sv)
    np.testing.assert_array_equal(uv, jtex.planar_uvs(
        np.random.default_rng(0), sv))
    assert uv.min() >= 0 and uv.max() <= 1
    img = np.random.default_rng(1).uniform(size=(20, 33, 3)).astype(np.float32)
    for size in (16, 20, 64):
        np.testing.assert_array_equal(texgen.resize_texture(img, size),
                                      jtex.resize_texture(img, size))


def test_pack_atlas_matches_jax_and_does_not_bleed():
    from torch_renderer_tpu_torch.structures.textures import TexturesUV

    t0 = np.zeros((32, 32, 3), np.float32)
    t0[..., 0] = 1.0
    t1 = np.zeros((32, 32, 3), np.float32)
    t1[..., 1] = 1.0
    uv = np.stack(np.meshgrid(np.linspace(0, 1, 9), np.linspace(0, 1, 9)),
                  -1).reshape(-1, 2).astype(np.float32)
    atlas, packed = texgen.pack_atlas([t0, t1, t0], [uv, uv, uv])
    jatlas, jpacked = jtex.pack_atlas([t0, t1, t0], [uv, uv, uv])
    np.testing.assert_array_equal(atlas, jatlas)
    for a, b in zip(packed, jpacked):
        np.testing.assert_array_equal(a, b)
    tex = TexturesUV(maps=torch.as_tensor(atlas)[None],
                     faces_uvs=torch.zeros((1, 1, 3), dtype=torch.int64),
                     verts_uvs=torch.as_tensor(packed[0])[None])
    for uvs, want in ((packed[0], [1, 0, 0]), (packed[1], [0, 1, 0])):
        s = tex.sample(torch.as_tensor(uvs)[None]).numpy()[0]
        np.testing.assert_allclose(s, np.broadcast_to(want, s.shape),
                                   atol=1e-6)


# -- the library and the writer ----------------------------------------------

def _write_obj(path, verts, faces):
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in faces:
            f.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")


def test_object_library_loaders_match_jax(tmp_path):
    sv, sf = icosphere(1)
    cv, cf = cube(2.0)
    _write_obj(tmp_path / "ball.obj", sv * 3.0 + 1.0, sf)
    _write_obj(tmp_path / "crate.obj", cv, cf)
    paths = [str(tmp_path / "ball.obj"), str(tmp_path / "crate.obj")]
    cmap = {"ball": {"id": 7, "supercategory": "toys"}}
    for kw in (dict(), dict(normalize=False, mm2m=True)):
        got = coco.ObjectLibrary.from_obj_files(paths, cmap, **kw).entries
        ref = jcoco.ObjectLibrary.from_obj_files(paths, cmap, **kw).entries
        for a, b in zip(got, ref):
            assert {k: v for k, v in a.items() if k not in ("verts", "faces")} \
                == {k: v for k, v in b.items() if k not in ("verts", "faces")}
            np.testing.assert_allclose(a["verts"], b["verts"], atol=1e-6)
            np.testing.assert_array_equal(a["faces"], b["faces"])
    with open(tmp_path / "instances.json", "w") as f:
        json.dump({"dataset_name": "unit_fixture", "categories": [
            {"id": 11, "name": "sphere", "supercategory": "round",
             "filename": "ball.obj"},
            {"id": 22, "name": "box", "supercategory": "square",
             "filename": "crate.obj"}]}, f)
    lib = coco.ObjectLibrary.from_instances_json(str(tmp_path))
    jlib = jcoco.ObjectLibrary.from_instances_json(str(tmp_path))
    assert lib.dataset_name == jlib.dataset_name == "unit_fixture"
    assert [e["category_id"] for e in lib.entries] == [11, 22]
    assert [e["name"] for e in lib.entries] == \
        [e["name"] for e in jlib.entries]


def test_reformat_and_unpack_match_jax():
    c = {"images": [], "annotations": [{"id": 0, "category_id": 7}],
         "categories": [{"id": 7, "name": "a"}, {"id": 42, "name": "b"}]}
    assert coco.reformat_coco_annotations(c) == \
        jcoco.reformat_coco_annotations(c)
    out = coco.reformat_coco_annotations(c)
    assert coco.reformat_coco_annotations(out) == out
    d = np.array([[0, 1, 65535]], np.uint16)
    np.testing.assert_array_equal(coco.unpack_depth(d), jcoco.unpack_depth(d))
    n = np.array([-127, 0, 5, 127], np.int8)
    np.testing.assert_array_equal(coco.unpack_normals(n),
                                  jcoco.unpack_normals(n))


def test_device_mesh_and_bad_configs_raise():
    lib = coco.ObjectLibrary.primitives(1, level=0)
    with pytest.raises(TypeError, match="DeviceMesh"):
        coco.COCODataGenerator(lib, coco.DataGenConfig(), device_mesh=object(),
                               device="cpu")
    flagged = coco.ObjectLibrary.primitives(1, level=0)
    flagged.entries[0]["distractor"] = True
    with pytest.raises(ValueError):
        coco.COCODataGenerator(flagged, device="cpu")
    with pytest.raises(ValueError):
        coco.COCODataGenerator(lib, coco.DataGenConfig(
            distractors_per_scene=(1, 1)), device="cpu")


def test_room_scene_bin_budgets_fit_hard_k1():
    """The generator's bin budgets at the full 480x640 on a room scene of
    the app's defaults (measured by count_overflow, 1.3x head-room, steps
    of 64) exceed 128 slots, full size at tile 32 and quarter size at tile
    16. hard_k1 streams a tile's slots through shared memory in chunks of
    kK1Chunk = 128 (csrc/hard_raster.cu), so any budget fits, and a tile of
    32^2 = 1024 pixels is its MAX_TILE_PIXELS (one thread a pixel)."""
    from torch_renderer_tpu_torch.rasterize import cuda_hard

    src = open(os.path.join(os.path.dirname(cuda_hard.__file__), "..",
                            "csrc", "hard_raster.cu")).read()
    assert "constexpr int kK1Chunk = 128;" in src
    assert "constexpr int kMaxPixels = 1024;" in src
    cfg = coco.DataGenConfig(room=True, min_visible_px=200)
    gen = coco.COCODataGenerator(coco.ObjectLibrary.primitives(), cfg,
                                 device="cpu")
    rng = np.random.default_rng(0)
    scene, _ = gen.sample_scene(rng)
    Rs, ts = gen._sample_view_poses(rng, 8, gen._object_centers(scene))
    gen._ensure_bin_capacity(scene.meshes.extend(8), Rs, ts)
    print(f"room scene budgets: full size {gen._mfb}, quarter size "
          f"{gen._vis_mfb}")
    assert gen._mfb > 128 and gen._vis_mfb > gen._mfb
    assert gen.renderer.settings.max_faces_per_bin == gen._mfb
    assert gen._vis_renderer.settings.max_faces_per_bin == gen._vis_mfb
    assert cfg.bin_size ** 2 == cuda_hard.MAX_TILE_PIXELS
    assert 16 ** 2 <= cuda_hard.MAX_TILE_PIXELS


@pytest.fixture
def app_budget_default():
    """The app sets the process-wide budget-check default for its run; put
    the default (None) back, so later tests in this process see it."""
    yield
    binning.set_budget_check_default(None)


def test_app_main_runs_on_cpu(tmp_path, capsys, app_budget_default):
    from torch_renderer_tpu_torch.apps import coco_data_generator as app

    out = app.main(["--device", "cpu", "--scenes", "1",
                    "--views-per-scene", "2", "--height", "48", "--width",
                    "64", "--out-dir", str(tmp_path), "--reformat",
                    "--edge-maps", "--room", "--min-visible-px", "60"])
    text = capsys.readouterr().out
    assert "rendered 2 rgbd images (1 scenes)" in text
    assert out["images"] == 2 and out["annotations"] >= 1
    assert out["images_per_s"] > 0
    assert (tmp_path / "annotations_contiguous.json").exists()
    assert len(list((tmp_path / "images").glob("*.png"))) == 2
    assert all(a["area"] >= 60 for a in out["coco"]["annotations"])
    # --mesh-shape 1,1: a world of one rank, in this process
    meshed = app.main(["--device", "cpu", "--scenes", "1",
                       "--views-per-scene", "2", "--height", "48", "--width",
                       "64", "--out-dir", str(tmp_path / "meshed"),
                       "--edge-maps", "--room", "--min-visible-px", "60",
                       "--mesh-shape", "1,1"])
    assert "device mesh {'data': 1, 'model': 1}" in capsys.readouterr().out
    assert meshed["coco"]["annotations"] == out["coco"]["annotations"]
    assert len(list((tmp_path / "meshed" / "images").glob("*.png"))) == 2

"""The port's native host runtime (io/native.py, io/native_obj.py: the
shared native/*.cpp built by g++ into build/native/) and PLY IO (io/ply.py)
against the JAX package's modules on the same inputs, and the pure-Python
fallbacks that run when the library cannot be built.

RLE and PNG are exact: the native RLE must equal the numpy encoder, and a
PNG must decode to the written pixels (read back by zlib, with no imaging
package). OBJ parsing and PLY round trips match the JAX package's values
within 1e-5.
"""

import os
import struct
import zlib

import numpy as np
import pytest

from torch_renderer_tpu.io import ply as jply
from torch_renderer_tpu.ops.icosphere import icosphere
from torch_renderer_tpu_torch.io import native, native_obj, obj, ply
from torch_renderer_tpu_torch.io.png import write_png

OBJ_TEXT = b"""
# test mesh
mtllib thing.mtl
v 0.0 0.0 0.0
v 1.0 0.0 0.0
v 1.0 1.0 0.5
v 0.0 1.0 -0.5
vt 0.0 0.0
vt 1.0 0.0
vt 1.0 1.0
vt 0.0 1.0
vn 0.0 0.0 1.0
f 1/1/1 2/2/1 3/3/1 4/4/1
f 1//1 3//1 4//1
f -4 -3 -2
"""


def _numpy_rle(mask):
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    return [0] + runs if flat[0] == 1 else runs


def read_png(path):
    """Decode an 8-bit, non-interlaced PNG written with filter 0 rows (what
    both encoders write) into (H, W, C) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    W, H, depth, ctype = hdr[:4]
    assert depth == 8
    C = {0: 1, 2: 3, 6: 4}[ctype]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, W * C + 1)
    assert (raw[:, 0] == 0).all()          # filter 0 on every row
    return raw[:, 1:].reshape(H, W, C)


@pytest.fixture(scope="module")
def lib_built():
    assert native.native_available(), (
        "the native library did not build (g++ and zlib are in this image)")
    path = native.library_path()
    assert path.parent.parent == native.BUILD_ROOT
    return path


def test_builds_into_build_native_only(lib_built):
    root = native._ROOT
    assert lib_built.is_file()
    assert str(lib_built).startswith(str(root / "build" / "native"))
    # nothing the port builds lands under native/
    assert not any(p.name.startswith("libtrt_torch")
                   for p in (root / "native").iterdir())


def test_parse_obj_counts_and_values(lib_built):
    out = native.parse_obj_bytes(OBJ_TEXT)
    np.testing.assert_allclose(
        out["verts"], [[0, 0, 0], [1, 0, 0], [1, 1, 0.5], [0, 1, -0.5]],
        atol=1e-6)
    assert out["uvs"].shape == (4, 2) and out["normals"].shape == (1, 3)
    assert out["faces"].shape == (4, 3)
    np.testing.assert_array_equal(out["faces"][0], [0, 1, 2])
    np.testing.assert_array_equal(out["faces"][1], [0, 2, 3])
    np.testing.assert_array_equal(out["faces"][3], [0, 1, 2])  # negative idx
    assert (out["faces_uv"][2] == -1).all()
    assert (out["faces_uv"][0] >= 0).all()


def test_parse_scientific_notation(lib_built):
    out = native.parse_obj_bytes(b"v 1.5e-2 -2E1 +0.25\nv\t1 2 3\nf 1 2 1\n")
    np.testing.assert_allclose(out["verts"][0], [0.015, -20.0, 0.25],
                               rtol=1e-5)


def test_load_obj_native_equals_python(lib_built, tmp_path, monkeypatch):
    """load_obj through the native hook equals the pure-Python parser and
    the JAX package's loader on a saved icosphere with UVs."""
    from torch_renderer_tpu.io import obj as jobj

    verts, faces = icosphere(2)
    uvs = np.random.default_rng(0).uniform(size=(verts.shape[0], 2)).astype(
        np.float32)
    p = str(tmp_path / "ico.obj")
    obj.save_obj(p, verts, faces, verts_uvs=uvs, faces_uvs=faces)
    nat = obj.load_obj(p, load_textures=False)
    monkeypatch.setattr(native_obj, "parse_obj", lambda path: None)
    py = obj.load_obj(p, load_textures=False)
    ref = jobj.load_obj(p, load_textures=False)
    for d in (nat, py):
        np.testing.assert_allclose(d.verts, ref.verts, atol=1e-5)
        np.testing.assert_array_equal(d.faces, ref.faces)
        np.testing.assert_allclose(d.verts_uvs, ref.verts_uvs, atol=1e-5)
        np.testing.assert_array_equal(d.faces_uvs, ref.faces_uvs)
    np.testing.assert_allclose(nat.verts, verts, atol=1e-5)


@pytest.mark.parametrize("shape", [(37, 53), (480, 640), (1, 7)])
def test_rle_native_equals_numpy(lib_built, shape):
    rng = np.random.default_rng(sum(shape))
    for thresh in (0.6, 0.0, 1.0):            # random, full, empty
        mask = rng.uniform(size=shape) >= thresh
        got = native.rle_encode(mask)
        assert got["counts"] == _numpy_rle(mask)
        assert got["size"] == list(shape)
        assert sum(got["counts"]) == shape[0] * shape[1]


def test_rle_empty_and_full(lib_built):
    assert native.rle_encode(np.zeros((4, 5), bool))["counts"] == [20]
    assert native.rle_encode(np.ones((4, 5), bool))["counts"] == [0, 20]


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3), (16, 24, 4),
                                   (48, 64, 1)])
def test_png_roundtrip(lib_built, tmp_path, shape):
    """The native encoder and io/png.py both decode back to the pixels."""
    img = np.random.default_rng(len(shape)).integers(0, 256, shape,
                                                      dtype=np.uint8)
    a, b = str(tmp_path / "native.png"), str(tmp_path / "plain.png")
    assert native.png_write(a, img)
    write_png(b, img)
    for p in (a, b):
        np.testing.assert_array_equal(read_png(p).reshape(img.shape), img)


def test_png_rejects_bad_input(lib_built, tmp_path):
    with pytest.raises(ValueError):
        native.png_write(str(tmp_path / "x.png"), np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        native.png_write(str(tmp_path / "x.png"), np.zeros((4, 4, 2), np.uint8))


def test_fallbacks_without_library(monkeypatch, tmp_path):
    """Without a built library every entry point says so, and the COCO
    writer's fallbacks (numpy RLE, io/png.py) give the same results."""
    from torch_renderer_tpu_torch.datagen.coco import COCODataGenerator

    mask = np.random.default_rng(1).uniform(size=(20, 30)) > 0.5
    with_lib = COCODataGenerator._mask_to_rle(mask)
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.native_available()
    assert native.parse_obj_bytes(OBJ_TEXT) is None
    assert native.rle_encode(mask) is None
    img = np.zeros((4, 5, 3), np.uint8)
    assert native.png_write(str(tmp_path / "n.png"), img) is False
    assert COCODataGenerator._mask_to_rle(mask) == with_lib
    COCODataGenerator._write_png(str(tmp_path / "f.png"), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "f.png")), img)


# -- PLY ---------------------------------------------------------------------

@pytest.mark.parametrize("binary", [True, False])
def test_ply_mesh_roundtrip_matches_jax(tmp_path, binary):
    verts, faces = icosphere(1)
    colors = np.clip(0.5 + 0.5 * verts, 0, 1).astype(np.float32)
    a, b = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    ply.save_ply(a, verts, faces=faces, colors=colors, binary=binary)
    jply.save_ply(b, verts, faces=faces, colors=colors, binary=binary)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    out, ref = ply.load_ply(a), jply.load_ply(a)
    np.testing.assert_allclose(out["verts"], verts, atol=1e-5)
    np.testing.assert_array_equal(out["faces"], faces)
    np.testing.assert_allclose(out["colors"], colors, atol=1.0 / 255)
    for k in ("verts", "faces", "colors"):
        np.testing.assert_array_equal(out[k], ref[k])


@pytest.mark.parametrize("binary", [True, False])
def test_ply_pointcloud_roundtrip(tmp_path, binary):
    pts = np.random.default_rng(0).standard_normal((50, 3)).astype(np.float32)
    normals = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    path = str(tmp_path / "pcd.ply")
    ply.save_ply(path, pts, normals=normals, binary=binary)
    out = ply.load_ply(path)
    np.testing.assert_allclose(out["verts"], pts, atol=1e-5)
    np.testing.assert_allclose(out["normals"], normals, atol=1e-5)
    assert out["faces"] is None


def test_ply_quad_faces_triangulated(tmp_path):
    path = str(tmp_path / "quad.ply")
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 4\n"
                "property float x\nproperty float y\nproperty float z\n"
                "element face 1\nproperty list uchar int vertex_indices\n"
                "end_header\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n")
    out = ply.load_ply(path)
    np.testing.assert_array_equal(out["faces"], [[0, 1, 2], [0, 2, 3]])
    np.testing.assert_array_equal(out["faces"], jply.load_ply(path)["faces"])


def test_ply_rejects_other_files(tmp_path):
    path = tmp_path / "x.ply"
    path.write_bytes(b"not a ply\n")
    with pytest.raises(ValueError):
        ply.load_ply(str(path))
    assert os.path.exists(path)

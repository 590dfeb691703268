"""ctypes bindings for the native host-runtime library (PyTorch counterpart
of ``torch_renderer_tpu.io.native``): OBJ parsing, COCO RLE mask encoding
and PNG encoding, the host-side hot spots of IO and data generation.

The C++ sources are the repository's shared ``native/objparse.cpp`` and
``native/pngwrite.cpp``. At first use they are compiled by one ``g++`` into
``build/native/<hash of the sources and flags>/`` at the repository root
and loaded with ctypes; nothing is written under ``native/``. Processes
that reach the build at once are safe (``_build.locked_build``: one
compiles under a lock, the others load its file). Every entry point has a
pure-Python fallback (None / False when there is no g++ or its build
fails), so the package works without a toolchain: this is host code only.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from .._build import locked_build

_ROOT = Path(__file__).resolve().parents[2]
SOURCES = (_ROOT / "native" / "objparse.cpp", _ROOT / "native" / "pngwrite.cpp")
BUILD_ROOT = _ROOT / "build" / "native"
LIB_NAME = "libtrt_torch_native.so"
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
LIBS = ("-lz",)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Optional[Path]:
    """Compile the library unless this exact build exists; its path, or
    None when there is no g++ or the build fails (build.log beside it).
    Never raises for a concurrent build: one process compiles, the others
    wait for it and return its file."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None or not all(s.is_file() for s in SOURCES):
        return None

    def compile_to(tmp: Path) -> bool:
        cmd = [cxx, *FLAGS, "-o", str(tmp), *map(str, SOURCES), *LIBS]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            (out.parent / "build.log").write_text(f"$ {' '.join(cmd)}\n{e}\n")
            return False
        (out.parent / "build.log").write_text(
            f"$ {' '.join(cmd)}\n# rc {res.returncode}\n{res.stdout}"
            f"{res.stderr}")
        return res.returncode == 0

    try:
        return locked_build(out, compile_to)
    except OSError:
        return None    # the build directory cannot be written


@functools.cache
def _load() -> Optional[ctypes.CDLL]:
    """Build if needed and load the library with its C signatures; None if
    it is unavailable."""
    path = build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(i32)
    lib.objparse_count.restype = ctypes.c_int
    lib.objparse_count.argtypes = [ctypes.c_char_p, i64, ctypes.POINTER(i64)]
    lib.objparse_parse.restype = ctypes.c_int
    lib.objparse_parse.argtypes = [ctypes.c_char_p, i64, fp, fp, fp,
                                   ip, ip, ip]
    lib.rle_encode.restype = i64
    lib.rle_encode.argtypes = [ctypes.POINTER(ctypes.c_uint8), i64, i64, ip]
    lib.png_write8.restype = ctypes.c_int
    lib.png_write8.argtypes = [ctypes.c_char_p, i64, i64, i64,
                               ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    return lib


def native_available() -> bool:
    return _load() is not None


def parse_obj_bytes(data: bytes) -> Optional[Dict[str, np.ndarray]]:
    """Parse OBJ text with the native parser: dict(verts (V,3) f32, uvs
    (T,2) f32, normals (N,3) f32, faces / faces_uv / faces_n (F,3) i32 with
    -1 for absent uv or normal indices), or None without the library."""
    lib = _load()
    if lib is None:
        return None
    counts = (ctypes.c_int64 * 4)()
    lib.objparse_count(data, len(data), counts)
    nv, nvt, nvn, ntri = (int(c) for c in counts)
    verts = np.empty((max(nv, 1), 3), np.float32)
    uvs = np.empty((max(nvt, 1), 2), np.float32)
    normals = np.empty((max(nvn, 1), 3), np.float32)
    faces = np.empty((max(ntri, 1), 3), np.int32)
    faces_uv = np.empty((max(ntri, 1), 3), np.int32)
    faces_n = np.empty((max(ntri, 1), 3), np.int32)

    def fp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    lib.objparse_parse(data, len(data), fp(verts), fp(uvs), fp(normals),
                       ip(faces), ip(faces_uv), ip(faces_n))
    return {"verts": verts[:nv], "uvs": uvs[:nvt], "normals": normals[:nvn],
            "faces": faces[:ntri], "faces_uv": faces_uv[:ntri],
            "faces_n": faces_n[:ntri]}


def rle_encode(mask: np.ndarray) -> Optional[Dict]:
    """COCO uncompressed RLE (column-major counts, a zero run first) by the
    native encoder; None without the library."""
    lib = _load()
    if lib is None:
        return None
    m = np.ascontiguousarray(np.asarray(mask, np.uint8))
    h, w = m.shape
    counts = np.empty(h * w + 1, np.int32)
    n = lib.rle_encode(m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
                       counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return {"size": [int(h), int(w)], "counts": counts[:n].tolist()}


def png_write(path: str, image: np.ndarray, level: int = 1) -> bool:
    """Write an 8-bit gray / RGB / RGBA PNG by the native encoder (rows
    unfiltered, zlib ``level``; ctypes releases the GIL during the call, so
    writer threads overlap the device's work). False when the library is
    unavailable or the write failed: callers fall back to io/png.py."""
    lib = _load()
    if lib is None:
        return False
    img = np.ascontiguousarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"png_write expects uint8, got {img.dtype}")
    if img.ndim == 2:
        h, w, c = img.shape[0], img.shape[1], 1
    elif img.ndim == 3 and img.shape[2] in (1, 3, 4):
        h, w, c = img.shape
    else:
        raise ValueError(f"unsupported image shape {img.shape}")
    rc = lib.png_write8(str(path).encode(), w, h, c,
                        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                        int(level))
    return rc == 0

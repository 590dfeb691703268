"""Build and load the package's hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface. At first use they are
compiled by ``nvcc`` for Hopper (sm_90a) into one shared library under
``build/kernels/<hash of the sources and flags>/`` at the repository root,
and loaded with ctypes. Nothing is built or loaded when the package is
imported, and a failed build raises: no caller falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_ROOT = _PKG.parent / "build" / "kernels"
LIB_NAME = "libtrt_torch_kernels.so"
# -Xptxas -v only reports registers, shared memory and spills into build.log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the soft-coverage "
        "kernels are CUDA C++ and must be compiled for sm_90a on a machine "
        "with the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the kernels unless this exact build exists; returns the
    library path. The compiler's report goes to build.log beside it."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    log = (f"$ {' '.join(cmd)}\n# {time.perf_counter() - t0:.2f} s, "
           f"rc {res.returncode}\n{res.stdout}{res.stderr}")
    (out.parent / "build.log").write_text(log)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    return out


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's C signature
    (pointers and the stream as c_void_p, so none is cut to 32 bits)."""
    lib = ctypes.CDLL(str(build()))
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.trt_soft_coverage_fwd.argtypes = [vp, vp, vp, i32, i32, i32, i32,
                                          f32, f32, i32, vp]
    lib.trt_soft_coverage_fwd.restype = i32
    lib.trt_soft_coverage_bwd.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32,
                                          f32, f32, i32, vp]
    lib.trt_soft_coverage_bwd.restype = i32
    lib.trt_error_string.argtypes = [i32]
    lib.trt_error_string.restype = ctypes.c_char_p
    return lib

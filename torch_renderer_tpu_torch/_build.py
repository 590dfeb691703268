"""Build and load the package's hand-written CUDA kernels.

The sources under ``csrc/`` (``*.cu``, with the headers ``*.cuh`` they
share) have a plain C interface. At first use each ``.cu`` is compiled by
its own ``nvcc`` for Hopper (sm_90a), all started together, and
the objects are linked into one shared library under
``build/kernels/<hash of the sources and flags>/`` at the repository root,
which is loaded with ctypes. Nothing is built or loaded when the package is
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
HEADERS = tuple(sorted((_PKG / "csrc").glob("*.cuh")))   # part of the hash
BUILD_ROOT = _PKG.parent / "build" / "kernels"
LIB_NAME = "libtrt_torch_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# -Xptxas -v only reports registers, shared memory and spills into build.log.
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")


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
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the port's "
        "kernels are CUDA C++ and must be compiled for sm_90a on a machine "
        "with the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def _run(cmds):
    """Run the commands in parallel; returns (log text, first failing rc)."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    secs = time.perf_counter() - t0
    log = "".join(f"$ {' '.join(c)}\n# rc {p.returncode}\n{o}"
                  for c, p, o in zip(cmds, procs, outs))
    rc = next((p.returncode for p in procs if p.returncode), 0)
    return f"{log}# {secs:.2f} s\n", rc


def build() -> Path:
    """Compile the kernels unless this exact build exists; returns the
    library path. The compiler's report goes to build.log beside it."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = find_nvcc()
    objs = [out.with_name(f"{src.stem}.{tag}.o") for src in SOURCES]
    log, rc = _run([[nvcc, *COMPILE_FLAGS, "-o", str(o), str(src)]
                    for src, o in zip(SOURCES, objs)])
    tmp = out.with_name(f"{LIB_NAME}.{tag}")
    if not rc:
        link_log, rc = _run([[nvcc, *LINK_FLAGS, "-o", str(tmp),
                              *map(str, objs)]])
        log += link_log
    for o in objs:
        o.unlink(missing_ok=True)
    (out.parent / "build.log").write_text(log)
    if rc:
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
    lib.trt_hard_k1.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, f32, f32,
                                f32, i32, i32, vp]
    lib.trt_hard_k1.restype = i32
    lib.trt_hard_k1_plan.argtypes = [i32, ctypes.c_int64, vp, i32]
    lib.trt_hard_k1_plan.restype = i32
    lib.trt_topk_select.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32,
                                    f32, f32, f32, i32, vp]
    lib.trt_topk_select.restype = i32
    lib.trt_points_select.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32,
                                      i32, i32, f32, i32, f32, i32, vp]
    lib.trt_points_select.restype = i32
    lib.trt_points_plan.argtypes = [i32, i32, ctypes.c_int64, vp, i32]
    lib.trt_points_plan.restype = i32
    i64 = ctypes.c_int64
    # one packed argument block (bytes pass as a pointer, unconverted)
    for fn in (lib.trt_texsample_fwd, lib.trt_texsample_bwd):
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = i32
    lib.trt_texsample_args_size.argtypes = []
    lib.trt_texsample_args_size.restype = i32
    lib.trt_gather_tiles_fwd.argtypes = [vp, i32, vp, vp, i32, i32, i32, i32,
                                         i32, i32, i32, i32, vp]
    lib.trt_gather_tiles_fwd.restype = i32
    lib.trt_gather_tiles_bwd.argtypes = [vp, i32, vp, vp, i32, i64, i32, i32,
                                         i32, vp]
    lib.trt_gather_tiles_bwd.restype = i32
    lib.trt_untile_scatter_fields.argtypes = [vp, i32, vp, i32, i32, i32,
                                              i32, i32, i32, i32, i32, vp]
    lib.trt_untile_scatter_fields.restype = i32
    lib.trt_error_string.argtypes = [i32]
    lib.trt_error_string.restype = ctypes.c_char_p
    return lib


def raw_stream(index: int) -> int:
    """torch's current stream on CUDA device `index`, as the raw
    cudaStream_t (no torch.cuda.Stream object is built)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(index)


def check_launch(fn_name: str, rc: int) -> None:
    """Raise if entry point fn_name returned an error (the entry points
    return cudaGetLastError(): a refused launch never runs)."""
    if rc:
        raise RuntimeError(
            f"{fn_name} launch failed: CUDA error {rc} "
            f"({load_kernels().trt_error_string(rc).decode()})")


def launch(fn_name: str, *args, device) -> None:
    """Call entry point fn_name with args, then the device index and torch's
    current raw stream on it; raise if the launch was refused."""
    index = device.index
    check_launch(fn_name,
                 getattr(load_kernels(), fn_name)(*args, index,
                                                  raw_stream(index)))

"""Build and load the package's hand-written CUDA kernels.

The sources under ``csrc/`` (``*.cu``, with the headers ``*.cuh`` they
share) have a plain C interface. At first use each ``.cu`` is compiled by
its own ``nvcc`` for Hopper (sm_90a), all started together, and
the objects are linked into one shared library under
``build/kernels/<hash of the sources and flags>/`` at the repository root,
which is loaded with ctypes. Nothing is built or loaded when the package is
imported, and a failed build raises: no caller falls back.

Processes that reach a build at once (the ranks of a launch, test
workers, another checkout's processes sharing the tree) are safe: the
build holds an exclusive ``flock`` on a lock file in its hash directory
and looks for the library again under it, so one process compiles and the
others load its file; temporary files are named by ``mkstemp`` (unique by
``O_EXCL``, not by pid, which can repeat across pid namespaces) and the
library is published by an atomic ``os.replace``. ``locked_build`` holds
this protocol for the host library (io/native.py) too.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional

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


@contextlib.contextmanager
def _exclusive(directory: Path):
    """Hold an exclusive flock on ``directory/.lock`` for the block."""
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / ".lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def temp_file(out: Path, prefix: str, suffix: str) -> Path:
    """A new empty file beside ``out`` with a name no other process holds
    (mkstemp: O_EXCL), for a compiler to write over."""
    fd, name = tempfile.mkstemp(dir=out.parent, prefix=prefix, suffix=suffix)
    os.close(fd)
    return Path(name)


def locked_build(out: Path, compile_to: Callable[[Path], bool]
                 ) -> Optional[Path]:
    """``out``, built once however many processes ask at the same time.

    Under the lock of out's directory: out when it exists (another process
    built it); else compile_to(tmp) writes the library into a temp file
    beside it and returns whether it succeeded, and on success tmp is
    renamed onto out (atomic). Returns out, or None when compile_to
    failed. A rename that fails while out exists yields out."""
    if out.exists():
        return out
    with _exclusive(out.parent):
        if out.exists():
            return out
        tmp = temp_file(out, f"{out.name}.", ".tmp")
        try:
            if not compile_to(tmp):
                return None
            try:
                os.replace(tmp, out)   # a loader never sees half a file
            except OSError:
                if not out.exists():
                    raise
            return out
        finally:
            tmp.unlink(missing_ok=True)


def build() -> Path:
    """Compile the kernels unless this exact build exists; returns the
    library path. The compiler's report goes to build.log beside it; a
    failed compile raises RuntimeError with it."""
    out = library_path()
    failed = []

    def compile_to(tmp: Path) -> bool:
        nvcc = find_nvcc()
        objs = [temp_file(out, f"{src.stem}.", ".o") for src in SOURCES]
        try:
            log, rc = _run([[nvcc, *COMPILE_FLAGS, "-o", str(o), str(src)]
                            for src, o in zip(SOURCES, objs)])
            if not rc:
                link_log, rc = _run([[nvcc, *LINK_FLAGS, "-o", str(tmp),
                                      *map(str, objs)]])
                log += link_log
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
        (out.parent / "build.log").write_text(log)
        if rc:
            failed.append(log)
        return not rc

    if locked_build(out, compile_to) is None:
        raise RuntimeError(f"nvcc failed:\n{failed[0]}")
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
    lib.trt_topk_select.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32,
                                    i32, f32, f32, f32, i32, vp]
    lib.trt_topk_select.restype = i32
    lib.trt_points_select.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32,
                                      i32, i32, i32, f32, i32, f32, i32, vp]
    lib.trt_points_select.restype = i32
    for fn in (lib.trt_topk_device_lists, lib.trt_points_device_lists):
        fn.argtypes = [i32]
        fn.restype = i32
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
    lib.trt_svd3.argtypes = [vp, vp, vp, vp, i32, i32, vp]
    lib.trt_svd3.restype = i32
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

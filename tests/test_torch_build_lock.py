"""The port's two builds under concurrent first use (no JAX).

``io.native.build()`` (g++, the host library) and ``_build.build()`` (nvcc,
the kernels) are reached at once by the ranks of a launch and by test
workers. Eight spawned processes call each at the same moment into a
fresh build root, over three rounds: one compile a round, every process
gets the same loadable path, none raises, and nothing but the library,
its build.log and the lock is left. nvcc is a stub put first on PATH (a
Python script that sleeps 0.2 s and writes its -o output); g++ runs
through a wrapper that counts its calls.
"""

from __future__ import annotations

import ctypes
import multiprocessing as mp
import os
import stat
import sys
import traceback
from pathlib import Path

import pytest

from torch_renderer_tpu_torch import _build
from torch_renderer_tpu_torch.io import native

PROCS = 8
ROUNDS = 3
LOG_VAR = "TRT_TEST_BUILD_LOG"

CXX_WRAPPER = """#!/bin/sh
echo cxx >> "$TRT_TEST_BUILD_LOG"
exec g++ "$@"
"""

NVCC_STUB = f"""#!{sys.executable}
import os, sys, time
time.sleep(0.2)
args = sys.argv[1:]
with open(os.environ["{LOG_VAR}"], "a") as f:
    f.write(("link" if "-shared" in args else "compile") + "\\n")
if os.environ.get("TRT_TEST_NVCC_FAIL"):
    sys.exit("stub nvcc: failing as asked")
with open(args[args.index("-o") + 1], "w") as f:
    f.write("stub\\n")
"""


def _script(path: Path, text: str) -> Path:
    path.write_text(text)
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return path


def _builder(kind, roots, cxx, stub_dir, barrier, queue):
    """One process: for each round's root, wait for the others, then
    build into it; puts (status, path or error, loadable) per round."""
    out = []
    try:
        os.environ["PATH"] = stub_dir + os.pathsep + os.environ["PATH"]
        os.environ["CXX"] = cxx
        for root in roots:
            os.environ[LOG_VAR] = root + ".log"
            barrier.wait(timeout=120)
            try:
                if kind == "native":
                    native.BUILD_ROOT = Path(root)
                    p = native.build()
                    ok = p is not None and bool(ctypes.CDLL(str(p)))
                else:
                    _build.BUILD_ROOT = Path(root)
                    p = _build.build()
                    ok = p.read_text() == "stub\n"
                out.append(("ok", str(p), ok))
            except Exception:
                out.append(("error", traceback.format_exc(), False))
    except Exception:
        out.append(("error", traceback.format_exc(), False))
    queue.put(out)


def _concurrent(kind: str, tmp: Path) -> tuple:
    """Every process's results and each round's root."""
    cxx = _script(tmp / "cxx.sh", CXX_WRAPPER)
    stubs = tmp / "bin"
    stubs.mkdir()
    _script(stubs / "nvcc", NVCC_STUB)
    roots = [str(tmp / f"round{r}") for r in range(ROUNDS)]
    ctx = mp.get_context("spawn")
    barrier, queue = ctx.Barrier(PROCS), ctx.Queue()
    procs = [ctx.Process(target=_builder, args=(
        kind, roots, str(cxx), str(stubs), barrier, queue))
        for _ in range(PROCS)]
    for p in procs:
        p.start()
    try:
        results = [queue.get(timeout=240) for _ in procs]
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.terminate()
    return results, roots


def _calls(root: str) -> list:
    return Path(root + ".log").read_text().split()


def _left_over(root: str) -> set:
    """Every file under a round's root, by name."""
    return {p.name for p in Path(root).rglob("*") if p.is_file()}


@pytest.fixture(scope="module")
def native_runs(tmp_path_factory):
    return _concurrent("native", tmp_path_factory.mktemp("native_lock"))


@pytest.fixture(scope="module")
def kernel_runs(tmp_path_factory):
    return _concurrent("kernels", tmp_path_factory.mktemp("kernel_lock"))


def _check_rounds(results, roots, lib_name: str) -> None:
    assert len(results) == PROCS
    for proc in results:
        errors = [msg for status, msg, _ in proc if status != "ok"]
        assert not errors, errors[0]
        assert len(proc) == ROUNDS
    for r, root in enumerate(roots):
        paths = {proc[r][1] for proc in results}
        assert len(paths) == 1, paths
        path = Path(paths.pop())
        assert path.name == lib_name and path.is_file()
        assert str(path).startswith(root)
        assert all(proc[r][2] for proc in results)   # loadable everywhere


def test_native_build_concurrent_one_compile(native_runs):
    results, roots = native_runs
    _check_rounds(results, roots, native.LIB_NAME)
    for root in roots:
        assert _calls(root) == ["cxx"]


def test_kernel_build_concurrent_one_compile(kernel_runs):
    results, roots = kernel_runs
    _check_rounds(results, roots, _build.LIB_NAME)
    for root in roots:
        calls = _calls(root)
        assert calls.count("compile") == len(_build.SOURCES)
        assert calls.count("link") == 1


@pytest.mark.parametrize("kind", ["native", "kernels"])
def test_concurrent_builds_leave_only_the_library(kind, native_runs,
                                                  kernel_runs):
    _, roots = native_runs if kind == "native" else kernel_runs
    lib = native.LIB_NAME if kind == "native" else _build.LIB_NAME
    for root in roots:
        assert _left_over(root) == {lib, "build.log", ".lock"}
    # nothing the port builds lands under native/
    assert not any(p.name.startswith("libtrt_torch") or p.name == ".lock"
                   for p in (native._ROOT / "native").iterdir())


def test_native_build_failure_returns_none(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("CXX", "false")
    assert native.build() is None
    assert _left_over(str(tmp_path)) == {"build.log", ".lock"}


def test_kernel_build_failure_raises(tmp_path, monkeypatch):
    stubs = tmp_path / "bin"
    stubs.mkdir()
    _script(stubs / "nvcc", NVCC_STUB)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "kernels")
    monkeypatch.setenv("PATH", str(stubs) + os.pathsep + os.environ["PATH"])
    monkeypatch.setenv(LOG_VAR, str(tmp_path / "calls.log"))
    monkeypatch.setenv("TRT_TEST_NVCC_FAIL", "1")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()
    assert _left_over(str(tmp_path / "kernels")) == {"build.log", ".lock"}
    # a later call with a working compiler builds
    monkeypatch.delenv("TRT_TEST_NVCC_FAIL")
    assert _build.build().read_text() == "stub\n"


@pytest.mark.parametrize("published", [True, False])
def test_locked_build_rename_failure(tmp_path, monkeypatch, published):
    """A rename that fails while the library exists (another process
    published it) yields the library; one that fails otherwise raises."""
    out = tmp_path / "h" / "lib.so"

    def failing_replace(src, dst):
        if published:
            Path(dst).write_text("theirs")
        raise FileNotFoundError(src)

    monkeypatch.setattr(_build.os, "replace", failing_replace)
    compile_to = lambda tmp: tmp.write_text("mine") > 0     # noqa: E731
    if published:
        assert _build.locked_build(out, compile_to) == out
        assert out.read_text() == "theirs"
    else:
        with pytest.raises(FileNotFoundError):
            _build.locked_build(out, compile_to)
    assert _left_over(str(tmp_path)) == ({"lib.so", ".lock"} if published
                                         else {".lock"})

"""Start the ranks of a multi-card run: the port's stand-in for the JAX
package's one controller over every device.

``run_ranks(fn, world_size, backend, *args)`` spawns ``world_size``
processes with torch.multiprocessing, joins them in one process group
through a ``file://`` store (a TCP port could collide between concurrent
runs), calls ``fn(*args)`` in each and returns the ranks' results in rank
order. On a card each rank takes ``cuda:(rank % device_count)`` before
``fn`` runs, so an entry point's default device is the rank's own card;
the kernels are built in the parent first, so the ranks only load them.
A rank's exception is raised again in the parent (its traceback in the
message); a run that outlasts ``timeout`` seconds is stopped and raises
TimeoutError, each rank still running having written its threads' stacks
to stderr first.

A world of one runs ``fn`` in place: the caller's process joins a group of
one for the call. Under ``torchrun`` (RANK and WORLD_SIZE set) the apps
use the group they are given instead (``init_from_env``).

  from torch_renderer_tpu_torch.parallel.launch import run_ranks
  results = run_ranks(my_fn, 8, "gloo", inputs)     # my_fn importable
"""

from __future__ import annotations

import faulthandler
import gc
import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = 600.0
LEAVE_TIMEOUT = 30.0


def default_backend(world_size: int, device=None) -> str:
    """NCCL with one rank per card where there are enough cards; gloo
    otherwise (on the CPU, or several ranks sharing a card). device: the
    ranks' torch device (None: the card when there is one)."""
    on_card = torch.cuda.is_available() if device is None \
        else torch.device(device).type == "cuda"
    if on_card and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def _to_host(obj):
    """A result made ready for the parent: every tensor on the CPU."""
    from .mesh import tree_map

    return tree_map(lambda x: x.detach().cpu(), obj)


def _bind_device(rank: int, backend: str) -> None:
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    elif backend == "nccl":
        raise RuntimeError("the NCCL backend needs a CUDA device")


def _rank_main(rank, fn, world_size, backend, store, threads, timeout,
               args, conn):
    """One rank: bind the card, join the group, run fn, send the result,
    leave the group. The result (or the error) is sent first: leaving an
    NCCL group can wait on the other ranks' collectives, and a rank that
    failed must not wait for ranks that wait for it. Before leaving, the
    garbage is collected: a CUDA graph that captured NCCL work (a captured
    step left in a reference cycle) holds the communicator, and leaving
    the group waits until it is destroyed. A rank still running just
    before the launcher's timeout writes every thread's stack to
    stderr."""
    faulthandler.dump_traceback_later(
        max(1.0, timeout - max(15.0, 0.05 * timeout)))
    try:
        if threads:
            torch.set_num_threads(threads)
        _bind_device(rank, backend)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world_size)
        out = ("ok", _to_host(fn(*args)))
    except Exception as exc:   # sent to the parent, which raises it
        out = ("error", exc, traceback.format_exc())
    try:
        payload = pickle.dumps(out)
    except Exception:
        payload = pickle.dumps(("error", None, out[-1] if out[0] == "error"
                                else traceback.format_exc()))
    conn.send_bytes(payload)
    conn.close()
    faulthandler.cancel_dump_traceback_later()
    out = payload = None   # an error's traceback holds fn's frames
    gc.collect()
    if dist.is_initialized():
        dist.destroy_process_group()


def _run_in_place(fn, backend, args):
    """A world of one in the caller's process."""
    _bind_device(0, backend)
    tmp = tempfile.mkdtemp(prefix="trt_ranks_")
    try:
        dist.init_process_group(backend,
                                init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            return [fn(*args)]
        finally:
            gc.collect()   # as in _rank_main
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_ranks(fn, world_size: int, backend: str | None = None, *args,
              timeout: float = DEFAULT_TIMEOUT, threads: int | None = None):
    """fn(*args) on each of ``world_size`` ranks joined in one process
    group; returns the ranks' results in rank order (their tensors moved
    to the CPU). ``fn`` must be importable by name (a module-level
    function) and ``args`` picklable. backend None: default_backend.
    threads: torch's intra-op threads per rank (None leaves torch's
    default)."""
    if backend is None:
        backend = default_backend(world_size)
    if dist.is_available() and dist.is_initialized():
        raise RuntimeError("run_ranks starts its own process group; this "
                           "process already belongs to one")
    if backend == "nccl" or torch.cuda.is_available():
        from .._build import load_kernels

        load_kernels()   # built once here; the ranks load the library
    if world_size == 1:
        return _run_in_place(fn, backend, args)

    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="trt_ranks_")
    store = os.path.join(tmp, "store")
    procs, conns = [], []
    try:
        for rank in range(world_size):
            parent_end, child_end = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_rank_main, daemon=True, args=(
                rank, fn, world_size, backend, store, threads, timeout,
                args, child_end))
            p.start()
            child_end.close()
            procs.append(p)
            conns.append(parent_end)
        deadline = time.monotonic() + timeout
        results, failure = [None] * world_size, None
        pending = set(range(world_size))
        while pending and failure is None:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"run_ranks: ranks {sorted(pending)} did not finish "
                    f"within {timeout:.0f} s")
            for rank in sorted(pending):
                conn = conns[rank]
                if not conn.poll(0.05):
                    continue
                pending.discard(rank)
                try:
                    out = pickle.loads(conn.recv_bytes())
                except EOFError:
                    out = ("error", None, f"rank {rank} exited with code "
                           f"{procs[rank].exitcode} and sent no result")
                if out[0] == "ok":
                    results[rank] = out[1]
                else:
                    failure = (rank, out[1], out[2])
                    break
        if failure is not None:
            rank, exc, tb = failure
            msg = f"rank {rank} of {world_size} failed:\n{tb}"
            if isinstance(exc, Exception):
                raise exc from RuntimeError(msg)
            raise RuntimeError(msg)
        # every result is in: the ranks have LEAVE_TIMEOUT seconds to leave
        # the group, then are stopped
        leave = min(deadline, time.monotonic() + LEAVE_TIMEOUT)
        for p in procs:
            p.join(max(0.0, leave - time.monotonic()))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
        for c in conns:
            c.close()
        shutil.rmtree(tmp, ignore_errors=True)


def init_from_env(backend: str | None = None) -> bool:
    """Join the group torchrun describes (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT, LOCAL_RANK in the environment), binding the rank's card;
    False when those are not set or the group exists already."""
    if dist.is_initialized() or "RANK" not in os.environ \
            or "WORLD_SIZE" not in os.environ:
        return False
    world = int(os.environ["WORLD_SIZE"])
    backend = backend or default_backend(world)
    _bind_device(int(os.environ.get("LOCAL_RANK", os.environ["RANK"])),
                 backend)
    dist.init_process_group(backend)
    return True

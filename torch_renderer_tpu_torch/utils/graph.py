"""One step of a loop as a replay of a captured CUDA graph: the port's
counterpart of the JAX package's jitted ``lax.scan`` loops (the bench's
timed steps, the pose, joint, deform and vertex-colour fits), whose whole
loop is one compiled device call, and of its jitted calls (the depth
app's render, the COCO chunk and visibility count: ``CapturedCall``).
PyTorch launches each kernel from the host, so an eager step costs its
every launch on the host; a replay costs one call.

The step reads its inputs from, and writes its state into, tensors that
keep their addresses from call to call: parameters updated in place (an
optimizer, ``copy_``), static buffers, and a step counter on the device
where the step needs its index (``opt.history.MetricHistory``). Nothing in
it may read a device value back to the host: a capture cannot hold one,
and the eager first call runs under ``torch.cuda.set_sync_debug_mode
("error")`` so that a host read raises there, at the op that made it.
A step that draws random numbers names its ``torch.Generator``s: each is
registered with the graph before the capture, so that every replay draws
new numbers from the generator's current state and advances it as an
eager step would (an unregistered generator would replay the capture's
draws).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from .timing import count, span


# One side stream per device for every warm-up and capture: cuBLAS keeps a
# workspace for each stream it has run on for the life of the process, so a
# new stream per loop would hold on to one more workspace each time.
_SIDE_STREAMS: dict = {}


def _side_stream(device: torch.device):
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = _SIDE_STREAMS.get(index)
    if stream is None:
        stream = _SIDE_STREAMS[index] = torch.cuda.Stream(index)
    return stream


def resolve_capture(capture, device) -> bool:
    """capture=None: captured on a CUDA device, eager elsewhere; True
    needs a CUDA device (ValueError elsewhere); False: eager."""
    device = torch.device(device)
    if capture is None:
        return device.type == "cuda"
    if capture and device.type != "cuda":
        raise ValueError(f"capture=True needs a CUDA device (a CUDA graph "
                         f"replays CUDA kernels); got device {device}")
    return bool(capture)


class StepGraph:
    """Calls of ``step()``, each one step of a loop, with its outputs.

    Captured: the first call runs step() eagerly on the device's side
    stream (the loop's first iteration, and the warm-up a capture needs:
    the optimizer's state, budget records and library workspaces are made
    there); the second captures step() once in a torch.cuda.CUDAGraph on
    the same stream, which runs nothing, and replays it; every later call
    replays it. A replay returns the outputs of the capture, static
    tensors that each replay rewrites. A capture that fails raises: there
    is no eager fallback. Not captured: every call is step().

    generators: the CUDA ``torch.Generator``s step() draws from, registered
    with the graph before its capture (the device's default generator
    registers itself; passing it, or None, is harmless).

    Spans (``utils.timing``): every call runs in the host span "issue",
    the replay in "issue/replay"; step() runs in the span "step", whose
    device markers a graph captured with spans on replays. Each capture
    adds 1 to the counter "captures".
    """

    def __init__(self, step: Callable, device, capture=None,
                 generators: Sequence = ()):
        self.step = step
        self.device = torch.device(device)
        self.captured = resolve_capture(capture, self.device)
        self.generators = [g for g in generators if g is not None]
        self.graph = None
        self.outputs = None
        self._warm = False

    def __call__(self):
        with span("issue"):
            if not self.captured:
                return self._step()
            if self.graph is None:
                if not self._warm:
                    return self._warm_up()
                graph = torch.cuda.CUDAGraph()
                _register_generators(graph, self.generators)
                with torch.cuda.graph(graph,
                                      stream=_side_stream(self.device)):
                    self.outputs = self._step()
                self.graph = graph
                count("captures")
            with span("issue/replay"):
                self.graph.replay()
            return self.outputs

    def _step(self):
        """step() in the span "step" (captured with it when spans are on)."""
        with span("step", self.device):
            return self.step()

    def release(self) -> None:
        """Drop the graph and its outputs, so that the graph's private
        memory pool is returned once their tensors are gone; a later call
        captures anew."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.outputs = None

    def _warm_up(self):
        current = torch.cuda.current_stream(self.device)
        side = _side_stream(self.device)
        side.wait_stream(current)
        before = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(side):
                out = self._step()
        finally:
            torch.cuda.set_sync_debug_mode(before)
        current.wait_stream(side)
        self._warm = True
        return out


def _register_generators(graph, generators) -> None:
    for g in generators:
        if g.device.type != "cuda":
            raise ValueError(f"a captured step draws from a CUDA generator; "
                             f"got one on {g.device}")
        register = getattr(graph, "register_generator_state", None)
        if register is None:
            raise RuntimeError(
                "this PyTorch cannot register a generator with a CUDA graph "
                "(CUDAGraph.register_generator_state); draw from the "
                "device's default generator (generator=None) instead")
        register(g)


# -- a call as a replay, over static copies of its inputs ---------------------

def _leaves(x, out: list) -> object:
    """The tensors of x (tensors, dataclasses, tuples and lists of them;
    other leaves are constants) into out; returns x's hashable signature:
    each tensor's shape, dtype, device and the dims it is expanded along
    (stride 0), each constant's value."""
    if isinstance(x, torch.Tensor):
        out.append(x)
        return ("T", tuple(x.shape), x.dtype, x.device, _expanded(x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x),) + tuple(_leaves(getattr(x, f.name), out)
                                  for f in dataclasses.fields(x) if f.init)
    if isinstance(x, (tuple, list)):
        return (type(x),) + tuple(_leaves(v, out) for v in x)
    return ("C", x)


def _expanded(x: torch.Tensor) -> tuple:
    return tuple(d for d in range(x.ndim)
                 if x.stride(d) == 0 and x.shape[d] > 1)


def _rebuild(x, it):
    """x's structure with its tensors taken in order from the iterator."""
    if isinstance(x, torch.Tensor):
        return next(it)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _rebuild(getattr(x, f.name), it)
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, (tuple, list)):
        return type(x)(_rebuild(v, it) for v in x)
    return x


class _StaticInput:
    """A static tensor shaped, typed and expanded as a source tensor: an
    expanded source (stride 0 along some dims, as ``Meshes.extend`` makes)
    gets a static base expanded the same way, so the captured call sees
    the strides the eager call sees."""

    def __init__(self, x: torch.Tensor):
        self.dims = _expanded(x)
        if self.dims:
            base = torch.empty([1 if d in self.dims else n
                                for d, n in enumerate(x.shape)],
                               dtype=x.dtype, device=x.device)
            self.base, self.view = base, base.expand(x.shape)
        else:
            self.base = self.view = torch.empty_like(x)

    def copy_from(self, x: torch.Tensor) -> None:
        for d in self.dims:
            x = x.narrow(d, 0, 1)
        self.base.copy_(x)


class CapturedCall:
    """Calls of ``fn(*args)`` (args: tensors, dataclasses of them such as
    Meshes or PointLights, tuples; other values are constants) as replays
    of captured CUDA graphs, the port's counterpart of a ``jax.jit`` call.

    Captured: one graph per input signature (shapes, dtypes, expanded
    dims, constants). Its first call makes static copies of the inputs and
    a StepGraph of fn over them, copies its inputs in (``copy_``, on the
    current stream), runs the StepGraph's eager warm-up (its outputs
    dropped) and its capture, and replays it, as a jitted function
    compiles in its first call; every later call copies its inputs in
    and replays. A replay
    returns the capture's outputs, which the next call of the same graph
    overwrites: copy out what must outlive it (work on the current stream
    is ordered before the next replay). Not captured: every call is
    fn(*args).

    "warn" budget checks made inside fn are recorded on the device in this
    call's own record, which outlives the caller's blocks as the graphs
    do; ``warn_budgets()`` warns once for each budget that overflowed
    since its last call (a host read).

    ``bodies`` counts the bodies this call ran from the host (an eager
    call, a warm-up or a capture: each launches fn's kernels once; a
    replay launches from its graph and counts nothing), and adds each to
    the ``utils.timing`` counter "call_bodies" of every call.
    Spans: a call runs in the host span "issue", with the signature walk
    in "issue/key" and the static input copies in "issue/copy_in".
    """

    def __init__(self, fn: Callable, device, capture=None):
        from ..rasterize.binning import BudgetRecord

        self.fn = fn
        self.device = torch.device(device)
        self.captured = resolve_capture(capture, self.device)
        self.budgets = BudgetRecord()
        self.bodies = 0
        self._graphs: dict = {}

    def _run(self, *args):
        """fn's body, run from the host: an eager call, a warm-up or a
        capture."""
        self.bodies += 1
        count("call_bodies")
        return self.fn(*args)

    def __call__(self, *args):
        from ..rasterize.binning import recording_budgets

        with recording_budgets(self.budgets), span("issue"):
            if not self.captured:
                with span("step", self.device):
                    return self._run(*args)
            return self._through_static(*args)

    def _through_static(self, *args):
        """fn(*args) through the graph of args' signature: args copied
        into its static inputs, then a replay (the first call: the warm-up
        and the capture first; not captured, fn over the static inputs)."""
        with span("issue/key"):
            tensors: list = []
            key = _leaves(args, tensors)
            entry = self._graphs.get(key)
        first = entry is None
        if first:
            static = [_StaticInput(x) for x in tensors]
            views = _rebuild(args, iter([s.view for s in static]))
            graph = StepGraph(lambda: self._run(*views), self.device,
                              self.captured)
            entry = self._graphs[key] = (static, graph)
        static, graph = entry
        with span("issue/copy_in"):
            for s, x in zip(static, tensors):
                s.copy_from(x)
        if first and self.captured:
            graph()           # the eager warm-up
        return graph()

    def warn_budgets(self) -> None:
        self.budgets.warn()
        for seen in self.budgets.max.values():
            seen.zero_()

    def release(self) -> None:
        """Drop every graph and its static inputs."""
        for _, graph in self._graphs.values():
            graph.release()
        self._graphs.clear()

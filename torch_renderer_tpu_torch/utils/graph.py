"""One step of a loop as a replay of a captured CUDA graph: the port's
counterpart of the JAX package's jitted ``lax.scan`` loops (the bench's
timed steps, the pose fit, the joint fit), whose whole loop is one
compiled device call. PyTorch launches each kernel from the host, so an
eager step costs its every launch on the host; a replay costs one call.

The step reads its inputs from, and writes its state into, tensors that
keep their addresses from call to call: parameters updated in place (an
optimizer, ``copy_``), static buffers, and a step counter on the device
where the step needs its index (``opt.history.MetricHistory``). Nothing in
it may read a device value back to the host: a capture cannot hold one,
and the eager first call runs under ``torch.cuda.set_sync_debug_mode
("error")`` so that a host read raises there, at the op that made it.
"""

from __future__ import annotations

from typing import Callable

import torch


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
    """

    def __init__(self, step: Callable, device, capture=None):
        self.step = step
        self.device = torch.device(device)
        self.captured = resolve_capture(capture, self.device)
        self.graph = None
        self.outputs = None
        self._warm = False

    def __call__(self):
        if not self.captured:
            return self.step()
        if self.graph is None:
            if not self._warm:
                return self._warm_up()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=_side_stream(self.device)):
                self.outputs = self.step()
            self.graph = graph
        self.graph.replay()
        return self.outputs

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
                out = self.step()
        finally:
            torch.cuda.set_sync_debug_mode(before)
        current.wait_stream(side)
        self._warm = True
        return out

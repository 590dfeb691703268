"""Where the port's entry points put the tensors they build from host data.

The port runs on the card: an entry point given ``device=None`` builds on
the current CUDA device, and raises when no CUDA device is visible rather
than falling back to the CPU. Running on the CPU is asked for with
``device="cpu"``. Functions that take tensors follow their inputs' device
instead (``like``).
"""

from __future__ import annotations

import torch


def resolve_device(device=None, like=None) -> torch.device:
    """``device`` when given; else the device of ``like`` when it is a
    tensor; else the current CUDA device, or RuntimeError without one."""
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: the port runs on the card by "
            "default; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def draw(fn, generator: torch.Generator, shape, device) -> torch.Tensor:
    """fn(shape) (torch.rand or torch.randn) drawn from ``generator`` on
    its own device, then moved to ``device``: a seeded CPU generator gives
    the same draws whatever device the work runs on."""
    return fn(shape, generator=generator, device=generator.device).to(device)


def scalar_tensor(x, dtype, device) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)`` for a tensor or a
    Python number, with the same values; a number is written on the device
    by a fill kernel instead of copied from the host, a copy that waits for
    the device and that a captured CUDA graph cannot hold."""
    if isinstance(x, (bool, int, float)):
        return torch.full((), x, dtype=dtype, device=device)
    return torch.as_tensor(x, dtype=dtype, device=device)

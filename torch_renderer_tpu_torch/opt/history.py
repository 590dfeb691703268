"""Per-step metrics of a fit, kept on the device."""

from __future__ import annotations

from typing import Dict

import torch


class MetricHistory:
    """Each step's dict of 0-dim metric tensors, written without a read
    back to the host into column ``step`` of a preallocated (n_metrics,
    n_steps) buffer on the device; ``step`` is a 0-dim int64 counter on the
    device that each ``add`` advances, so a CUDA graph of the step (which
    replays the same write) fills the next column each replay. A step that
    needs its own index reads ``step`` before its ``add``. ``result()``
    gives {name: (n_steps,) tensor}, names sorted."""

    def __init__(self, n_steps: int, device):
        self.n_steps = int(n_steps)
        self.step = torch.zeros((), dtype=torch.int64, device=device)
        self._keys = None
        self._buf = None

    def add(self, metrics: Dict[str, torch.Tensor]) -> None:
        if self._buf is None:
            self._keys = sorted(metrics)
            self._buf = torch.zeros((len(self._keys), self.n_steps),
                                    device=self.step.device)
        row = torch.stack([metrics[k].detach() for k in self._keys])
        self._buf.index_copy_(1, self.step.view(1), row[:, None])
        self.step.add_(1)

    def result(self) -> Dict[str, torch.Tensor]:
        if self._buf is None:
            return {}
        return {k: self._buf[i] for i, k in enumerate(self._keys)}

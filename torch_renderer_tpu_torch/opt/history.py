"""Per-step metrics of a fit, kept on the device."""

from __future__ import annotations

from typing import Dict

import torch


class MetricHistory:
    """Collects each step's dict of 0-dim metric tensors without reading
    them back to the host, so the loop never waits for the device;
    ``result()`` stacks them into {name: (steps,) tensor}."""

    def __init__(self):
        self._keys = None
        self._rows = []

    def add(self, metrics: Dict[str, torch.Tensor]) -> None:
        self._keys = self._keys or sorted(metrics)
        self._rows.append(torch.stack([metrics[k].detach()
                                       for k in self._keys]))

    def result(self) -> Dict[str, torch.Tensor]:
        if not self._rows:
            return {}
        hist = torch.stack(self._rows, dim=1)
        return {k: hist[i] for i, k in enumerate(self._keys)}

"""Metrics logging: structured, batched, and without a host read until
asked (the port's copy of ``torch_renderer_tpu.utils.metrics``).

The reference logs wandb scalars and images every iteration from inside
its loop (camera_pose_optimizer.py:51-53, 270-273, 295-297), which waits
for the device each step. The port's fits return their metrics history
as stacked device tensors (opt/*.fit), and this logger flushes the whole
history at once to JSONL, stdout or wandb (when installed).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


class MetricLogger:
    """Sink for metric dicts; one .log_history() call per fit."""

    def __init__(
        self, jsonl_path: Optional[str] = None, use_wandb: bool = False,
        wandb_project: Optional[str] = None, print_every: int = 0,
    ):
        self.jsonl_path = jsonl_path
        self.print_every = print_every
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                if wandb.run is None:
                    wandb.init(project=wandb_project or "torch_renderer_tpu")
            except Exception:
                self._wandb = None  # wandb not installed, or offline
        if jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)),
                        exist_ok=True)
            self._f = open(jsonl_path, "a")
        else:
            self._f = None

    def log_step(self, metrics: Dict, step: int) -> None:
        row = {k: float(_host(v)) for k, v in metrics.items()}
        row["step"] = int(step)
        row["ts"] = time.time()
        if self._f:
            self._f.write(json.dumps(row) + "\n")
        if self._wandb:
            self._wandb.log(row, step=step)
        if self.print_every and step % self.print_every == 0:
            pretty = "  ".join(f"{k}={v:.5g}" for k, v in row.items()
                               if k not in ("step", "ts"))
            print(f"[{step}] {pretty}")

    def log_history(self, history: Dict, start_step: int = 0) -> None:
        """Flush a stacked history {name: (n_steps,) tensor} of a fit: one
        host read for the whole run."""
        arrays = {k: _host(v) for k, v in history.items()}
        n = len(next(iter(arrays.values())))
        for i in range(n):
            self.log_step({k: a[i] for k, a in arrays.items()},
                          start_step + i)
        if self._f:
            self._f.flush()

    def log_image(self, name: str, image, step: int = 0,
                  out_dir: Optional[str] = None) -> Optional[str]:
        """Image panel logging (the reference's wandb.Image panels,
        camera_pose_optimizer.py:331-341): sent to wandb when active,
        and/or written as a PNG under out_dir. Returns the written path
        (or None)."""
        img = _host(image)
        if img.ndim == 2:
            lo, hi = float(img.min()), float(img.max())
            img = (img - lo) / (hi - lo) if hi > lo else img * 0.0
            img = np.stack([img] * 3, axis=-1)
        img8 = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        if self._wandb:
            self._wandb.log({name: self._wandb.Image(img8)}, step=step)
        if out_dir:
            from PIL import Image

            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, f"{name}_{step:06d}.png")
            Image.fromarray(img8).save(path)
            return path
        return None

    def close(self) -> None:
        if self._f:
            self._f.close()

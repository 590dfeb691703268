"""The card's peaks and the operations a (pixel, face) pair costs.

Frozen copies of ``chip_smoke.py:369-395`` (the port's smoke test), so that
the rooflines do not move when the program changes.
"""

from __future__ import annotations

import subprocess

# NVIDIA H100 SXM data sheet, at its 700 W limit: HBM bytes/s and float32
# operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# Operations per (pixel, face) pair, read off the kernels' arithmetic (an
# exp or log1p counts as one): the soft pair's three clamped edge
# distances, inside test and softplus (forward) or sigmoid and tied-edge
# gradient (backward); the K = 1 selection's inside-only priority.
OPS_SOFT_FWD = 80
OPS_SOFT_BWD = 100
# Of the forward's 80, the softplus and its add to the sum (25 + 1): a pair
# whose x = -signed d2 / sigma lies below SOFT_CUTOFF adds exactly +0.0 in
# float32 and needs only its edge math.
OPS_SOFTPLUS = 26
OPS_SOFT_EDGE = OPS_SOFT_FWD - OPS_SOFTPLUS
SOFT_CUTOFF = -104.0
OPS_HARD_K1 = 35


def bound_s(n_ops: float, n_bytes: float) -> float:
    """The least time the card could take for this work, seconds."""
    return max(n_ops / FP32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"
    return out.stdout.strip().splitlines()[0]

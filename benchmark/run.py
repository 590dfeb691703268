"""Run one cell of the benchmark of ``torch_renderer_tpu_torch`` once, on
the card it is started on, and print its result as the last line of
standard output:

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

With --trace 0 the result holds the cell's end-to-end metrics; with
--trace 1 its per-layer metrics, the traced window's busy and window
seconds, and a breakdown of device time and idle gaps. Every run checks
what its timed path produced against the plain reference and prints each
compared number beside its limit as its last lines on standard error and
under "checks", the last key of the result. Without a CUDA card, or with
JAX or the JAX package loaded, it exits with code 1 and prints no result.
Run it from the root of a checkout: the program's kernels are built and
cached under ``build/`` there.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def process_age_s() -> float:
    """Seconds since this process started, from /proc (clock ticks)."""
    ticks = os.sysconf("SC_CLK_TCK")
    start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                .split()[19])
    uptime = float(Path("/proc/uptime").read_text().split()[0])
    return uptime - start / ticks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA card: the benchmark measures the port on the card",
              file=sys.stderr)
        return 1
    # the harness's own modules, then the program in the checkout's root
    sys.path[:0] = [str(HERE), str(ROOT)]
    from benchlib import peaks, runner

    card = peaks.card_line()
    out = runner.run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), setup_clock=process_age_s)
    found = runner.jax_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 1
    checks = out.pop("checks")
    correct = all(v <= limit for _, v, limit in checks)
    print("info: " + json.dumps({
        "card": card, "peaks": {"hbm_bytes_per_s": peaks.HBM_BYTES_PER_S,
                                "fp32_ops_per_s": peaks.FP32_OPS_PER_S},
        **out.pop("info"), "window": out.pop("window")}, default=str),
        flush=True)
    # only the state after the window is compared: when it does not hold,
    # every step of the window counts as failed
    attempted = out.pop("attempted")
    line = {"correct": correct, "attempted": attempted,
            "failed": 0 if correct else attempted, **out,
            "checks": {n: {"value": v, "limit": limit}
                       for n, v, limit in checks}}
    for n, v, limit in checks:
        print(f"check {n} {v!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings for the limits of a cell's check: for each seed, the program's
compared numbers after a short window at the cell's own load and size,
and the control's: the plain reference computed in bfloat16 (the nearest
precision below the float32 the configurations state) put in the
program's place. Every limit lies between the program's largest reading
(the lower) and the control's smallest (the upper); PERF.md gives both.

  python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \\
      --seconds 1 [--no-control] [--fault unchanged|half|altered]

With --fault the program runs with that fault planted under its timed
path (``faults.py``), and its readings are the fault's.

One process reads every seed, so set-up (the kernel build) is paid once.
The benchmark's own runs do not run this. Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def readings(workload: str, seed: int, seconds: float, control: bool,
             device: str = "cuda", config=None, traffic=None,
             fault: str | None = None) -> dict:
    """{"program": {name: value}, "control": {name: value} or None,
    "limits": {name: limit}} of one seed."""
    import torch

    import faults
    from benchlib import runner, window

    dev = torch.device(device)
    with faults.plant(workload, fault):
        c, scene, loop = runner.prepare(workload, seed, dev, config,
                                        traffic)
        tr, mod = c["traffic"], c["loop"]
        for i in range(tr["warmup_steps"]):
            loop.step(i)
        w = window.run(loop, seconds, tr["ahead"], dev.type == "cuda")
        result = loop.result()
    runner.release(loop, dev.type == "cuda")
    del loop
    out = {"steps": w["steps"]}
    checks = mod.check(result, scene, tr)
    out["program"] = {n: v for n, v, _ in checks}
    out["limits"] = {n: limit for n, _, limit in checks}
    if control:
        ctrl = mod.control(result, scene, tr)
        out["control"] = {n: v for n, v, _ in mod.check(ctrl, scene, tr)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--fault", choices=("unchanged", "half", "altered"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(args.workload, seed, args.seconds, not args.no_control,
                     fault=args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

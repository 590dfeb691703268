"""One run of one cell: the scene from the seed, the loop's set-up, the
measured window, the traced window (``trace``), the check against the
reference, and the result line's fields.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json``, its configuration file (the manifest's ``file``), its
traffic mix ``traffic/<traffic>.json``, the loop that mix names
``loops/<loop>.py``, each per-layer metric's reader ``metrics/<name>.py``
and each roofline's work count ``work/<operation>.py``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import statistics
import sys
from pathlib import Path

import torch

from benchlib import peaks, scene as scenes, trace, window

HERE = Path(__file__).resolve().parents[1]          # the benchmark's folder
ROOT = HERE.parent                                  # the checkout


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_file(path: Path, name: str):
    """The module in ``path``, imported under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader_file(metric: str) -> Path:
    """The reader of a per-layer metric: ``metrics/<name>.py``, or for a
    quantity split by the cells that report it (``<quantity>.<group>``)
    the quantity's ``metrics/<quantity>.py``."""
    parts = metric.split(".")
    for k in range(len(parts), 0, -1):
        path = HERE / "metrics" / (".".join(parts[:k]) + ".py")
        if path.is_file():
            return path
    raise FileNotFoundError(f"no reader for {metric!r} under metrics/")


def cell(workload: str) -> dict:
    """The cell's manifest entry with its configuration, traffic mix, loop
    and the per-layer metrics it reports, all resolved by name."""
    man = manifest()
    wl = {w["name"]: w for w in man["workloads"]}.get(workload)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in man["configs"]}[wl["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{wl['traffic']}.json")
                         .read_text())
    loop = importlib.import_module(f"loops.{traffic['loop']}")
    reports = [m for m in man["per_layer"]
               if workload in m.get("workloads", [workload])]
    e2e = [m for m in man["end_to_end"]
           if workload in m.get("workloads", [workload])]
    return {"workload": wl, "config": config, "traffic": traffic,
            "loop": loop, "per_layer": reports, "end_to_end": e2e}


class Reading:
    """What a per-layer metric's reader reads: the traced window's device
    events and steps, the measured window's host times, the program's own
    kernel names and the work of each step."""

    def __init__(self, traced: dict, steps: range, host_s: list,
                 own: set, step_views, scene: dict):
        self.device = traced["device"]
        self.window_s = traced["window_s"]
        self.busy_s = trace.union_s(self.device)
        self.steps = steps
        self.host_s = host_s
        self.own = own
        self._views, self._scene, self._work = step_views, scene, {}

    def is_own(self, kernel: str) -> bool:
        return any(trace.has_name(kernel, k) for k in self.own)

    def kernel_s(self, ident: str):
        """(device seconds, launches) of the kernels named ident."""
        spans = [(b - a) / 1e6 for n, a, b in self.device
                 if trace.has_name(n, ident)]
        return sum(spans), len(spans)

    def step_work(self, operation: str) -> list:
        """[(operations, bytes)] of each traced step (work/<operation>)."""
        if operation not in self._work:
            module = importlib.import_module(f"work.{operation}")
            ops, nbytes = module.per_view(self._scene)
            self._work[operation] = (ops, nbytes)
        ops, nbytes = self._work[operation]
        out = []
        for i in self.steps:
            v = list(self._views(i))
            out.append((float(ops[v].sum()), float(nbytes[v].sum())))
        return out

    def roofline_pct(self, kernel: str, operation: str):
        """The traced steps' least time for the operation's work (by the
        peaks) over the kernel's device time, in percent; None where the
        kernel did not run."""
        seconds, launches = self.kernel_s(kernel)
        if not launches:
            return None
        least = sum(peaks.bound_s(o, b) for o, b in self.step_work(operation))
        return 100.0 * least / seconds


def p95(values: list) -> float:
    return statistics.quantiles(values, n=20)[18] if len(values) > 1 \
        else values[0]


def prepare(workload: str, seed: int, device: torch.device,
            config: dict | None = None, traffic: dict | None = None):
    """The cell (``config`` replaces its configuration and ``traffic``
    updates its traffic mix: the tests' small scenes), the scene of the
    seed and the loop built on it: (cell, scene, loop)."""
    c = cell(workload)
    if config is not None:
        c["config"] = config
    c["traffic"].update(traffic or {})
    cfg, mod = c["config"], c["loop"]
    scene = scenes.make_scene(cfg, seed, mod.scene_views(cfg, c["traffic"]),
                              device)
    return c, scene, mod.Loop(scene, c["traffic"], device)


def release(loop, cuda: bool) -> None:
    """Free the program's state (graphs, pools) before the reference runs,
    and run the reference as the configurations state: float32, TF32
    off."""
    loop.release()
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", setup_clock=None,
             config: dict | None = None, traffic: dict | None = None
             ) -> dict:
    """One run; ``setup_clock()`` gives the seconds since the process
    started. Returns the result line's fields and the compared numbers."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    c, scene, loop = prepare(workload, seed, dev, config, traffic)
    traffic, mod = c["traffic"], c["loop"]
    for i in range(traffic["warmup_steps"]):
        loop.step(i)
    if cuda:
        torch.cuda.synchronize()
    setup_s = setup_clock() if setup_clock else None
    w = window.run(loop, seconds, traffic["ahead"], cuda)
    traced_window = None
    if traced and cuda:
        traced_window = trace.profile(loop, w["steps"], traffic["trace_steps"])
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    info = {"sizing": loop.sizing}
    result = loop.result()
    images = w["steps"] * loop.images_per_step
    step_views = loop.step_views
    release(loop, cuda)
    del loop
    checks = mod.check(result, scene, traffic)
    metrics = {}
    if not traced:
        values = {"images_per_s": images / w["window_s"],
                  "step_ms_p95": p95(w["intervals_s"]) * 1e3,
                  "setup_s": setup_s}
        # a quantity split by the cells that report it keeps its value's
        # name before the first dot
        for m in c["end_to_end"]:
            value = values.get(m["name"].split(".")[0])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = {"metrics": metrics, "device": device_info, "checks": checks,
           "attempted": w["steps"], "info": info,
           "window": {"steps": w["steps"], "window_s": w["window_s"]}}
    if traced_window is not None:
        last = traced_window["next"]
        steps_of_trace = range(last - traffic["trace_steps"], last)
        reading = Reading(traced_window, steps_of_trace, w["host_s"],
                          trace.own_kernel_names(), step_views, scene)
        for m in c["per_layer"]:
            reader = load_file(reader_file(m["name"]),
                               f"metric_{m['name'].replace('.', '_')}")
            value = reader.read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = reading.busy_s
        device_info["window_s"] = reading.window_s
        out["breakdown"] = trace.breakdown(traced_window["device"],
                                           traced_window["cpu"])
        info["trace"] = {"steps": len(steps_of_trace),
                         "marks_kept": traced_window["marks"],
                         "attempts": traced_window["attempts"]}
    return out


def jax_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process, by
    whole top-level name (the port's name begins with the JAX package's)."""
    banned = {"jax", "jaxlib", "flax", "torch_renderer_tpu"}
    return sorted({m.split(".")[0] for m in list(sys.modules)} & banned)

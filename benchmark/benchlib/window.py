"""The measured window: steps issued from one host thread, ``ahead`` steps
dispatched ahead of the device, until ``seconds`` have run out.

The window opens after a synchronise and closes with one after the last
step issued before the time ran out; at least one whole cycle of the loop
(every slot of its result written) is issued. After each step an event is
recorded on the stream; the interval between consecutive events is the
step's completion interval, so a host stall lands in the step after it.
Before issuing step i the host waits for step i - ahead to complete, so
the host clock around a step's issuing call reads the host's own cost and
not a wait for the launch queue. The events are a ring made before the
window opens: a slot is recorded again only once its interval is read, so
the window creates none.
"""

from __future__ import annotations

import time

import torch


def run(loop, seconds: float, ahead: int, cuda: bool) -> dict:
    """Issue loop.step(0), loop.step(1), ... for ``seconds`` (on the CPU,
    for the tests: each step synchronous, timed by the host clock). Returns
    steps, window_s, intervals_s (per step) and host_s (per step's issuing
    call)."""
    host, intervals = [], []
    if cuda:
        # step k's event is ring[k % n]; its interval needs step k - 1's
        ring = [torch.cuda.Event(enable_timing=True)
                for _ in range(ahead + 2)]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        start.record()

        def read(k: int) -> None:
            prev = start if k == 0 else ring[(k - 1) % len(ring)]
            intervals.append(prev.elapsed_time(ring[k % len(ring)]) / 1e3)
    t0 = last = time.perf_counter()
    i = 0
    while True:
        if cuda and i >= ahead:
            ring[(i - ahead) % len(ring)].synchronize()
            read(i - ahead)
        if i >= loop.cycle and time.perf_counter() - t0 >= seconds:
            break
        a = time.perf_counter()
        loop.step(i)
        host.append(time.perf_counter() - a)
        if cuda:
            ring[i % len(ring)].record()
        else:
            now = time.perf_counter()
            intervals.append(now - last)
            last = now
        i += 1
    if cuda:
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    if cuda:
        for k in range(len(intervals), i):
            read(k)
    assert len(intervals) == i, (len(intervals), i)
    return {"steps": i, "window_s": window, "intervals_s": intervals,
            "host_s": host}

"""Device time of one kernel call, as `chip_smoke.py` and `kernels/sweep.py`
measure it."""
from __future__ import annotations

import statistics
import time

import torch


def time_ms(fn, iters: int) -> tuple[float, float]:
    """(median device time of one call in ms, host time of one call in us).
    CUDA events around each call; four long matrix products go first, so
    that the host enqueues every call while the device is still busy and the
    events see no host time. The host time is the enqueueing loop's."""
    for _ in range(3):
        fn()
    plug = torch.empty((8192, 8192), device="cuda")
    torch.cuda.synchronize()
    for _ in range(4):  # ~0.1 s of fp32 work: iters calls enqueue in less
        torch.mm(plug, plug)
    events = []
    t0 = time.perf_counter()
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    host_us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events), host_us

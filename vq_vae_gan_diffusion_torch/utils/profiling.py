"""Where a repeated call spends its time on the card: the report shared by
``profile_decode`` and ``profile_shuffle``."""

from __future__ import annotations

import time
from typing import Callable

import torch
from torch.profiler import ProfilerActivity, profile


def report(label: str, fn: Callable[[int], object], calls: int, enqueue_calls: int,
           unit: str) -> None:
    """Run ``fn(i)`` for i = 0..calls-1 (once to warm up, then measured) and
    print, per ``unit`` (one call of ``fn``):

    - the host-clock time, with the device synchronised at the end;
    - the host's own time to issue a call: the first ``enqueue_calls`` calls
      issued with no synchronise, few enough that their launches fit the
      launch queue and the host never waits;
    - from ``torch.profiler``: the device time summed over all CUDA kernels,
      the device's busy share of the host-clock window, and each kernel's
      device time and launches by name.
    """
    def sweep(n: int) -> None:
        for i in range(n):
            fn(i)

    sweep(calls)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep(calls)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / calls
    t0 = time.perf_counter()
    sweep(enqueue_calls)
    issue_ms = 1e3 * (time.perf_counter() - t0) / enqueue_calls
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep(calls)
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = sum(e.self_device_time_total for e in kernels)
    print(f"{label}: host clock {wall_ms:.4f} ms/{unit}; host issue {issue_ms:.4f} ms/{unit}; "
          f"device {dev_us / 1e3 / calls:.4f} ms/{unit}; device busy "
          f"{100 * dev_us / 1e3 / window_ms:.1f}% of the profiled window "
          f"({window_ms / calls:.4f} ms/{unit}); {torch.cuda.get_device_name(0)}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
        print(f"  {e.self_device_time_total / calls:10.2f} us/{unit}  "
              f"{e.count / calls:6.1f} launches/{unit}  {e.key[:90]}")

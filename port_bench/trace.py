"""The device trace of a profiled stretch: ``torch.profiler`` with CPU and
CUDA activity, exported as a Chrome trace to a temporary file, read back
into kernel intervals and host operations, and the file removed."""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def warm_up() -> None:
    """Start and stop the profiler once, in set-up: its first start
    initialises the device tracing, which takes seconds."""
    import torch

    with profiler():
        torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)


def read(prof) -> dict:
    """Kernels [(name, start us, end us)], device activity of any kind, and
    host operations [(name, start us, end us)] of the finished ``prof``."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    kernels, device, host = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        span = (e.get("name", ""), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append(span)
            if cat == "kernel":
                kernels.append(span)
        elif cat in HOST_CATS:
            host.append(span)
    return {"kernels": kernels, "device": device, "host": host}


def _union(spans: List[Tuple[str, float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for _, a, b in sorted(spans, key=lambda s: s[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_seconds(trace: dict) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(b - a for a, b in _union(trace["device"])) / 1e6


def kernel_seconds(trace: dict, name: str) -> Tuple[float, int]:
    """(summed device seconds, launches) of the kernels whose name holds
    ``name``."""
    spans = [s for s in trace["kernels"] if name in s[0]]
    return sum(b - a for _, a, b in spans) / 1e6, len(spans)


def breakdown(trace: dict, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, by name, and the idle
    gaps between device activity summed by the innermost host operation
    running at each gap's middle."""
    by_op: Dict[str, float] = {}
    for name, a, b in trace["device"]:
        by_op[name] = by_op.get(name, 0.0) + (b - a) / 1e6
    busy = _union(trace["device"])
    host = sorted(trace["host"], key=lambda s: s[1])
    gaps: Dict[str, float] = {}
    stack: List[Tuple[str, float, float]] = []     # host operations nest
    j = 0
    for (_, end), (start, _) in zip(busy[:-1], busy[1:]):
        mid = (end + start) / 2
        while j < len(host) and host[j][1] <= mid:
            while stack and stack[-1][2] < host[j][1]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        name = stack[-1][0] if stack else "no host operation"
        gaps[name] = gaps.get(name, 0.0) + (start - end) / 1e6
    ranked = lambda d: [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": ranked(by_op), "idle_gaps": ranked(gaps)}

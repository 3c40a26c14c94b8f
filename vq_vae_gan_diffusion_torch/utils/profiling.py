"""Where a repeated call spends its time on the card: the report shared by
``profile_decode`` and ``profile_shuffle``, and the card's published rates
with the ShuffleNet units' and the posterior kernels' bounds, random units,
CUDA-event timing and the card's ``nvidia-smi`` line, shared by the
profiles and ``chip_smoke.py``."""

from __future__ import annotations

import contextlib
import math
import os
import re
import subprocess
import time
from typing import Callable, Dict, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

F32_PEAK_FLOPS = 67e12      # H100 SXM, f32 outside the tensor cores
BF16_PEAK_FLOPS = 989e12    # H100 SXM, dense bf16 tensor cores


@contextlib.contextmanager
def profile_steps(logdir: str):
    """A ``torch.profiler`` trace of the block (CPU activity, and CUDA's
    where a card is visible), written as the Chrome trace
    ``<logdir>/trace.json`` when the block ends, also by an exception such
    as a SIGTERM's ``SystemExit(143)`` (the JAX package's ``profile_steps``
    writes a ``jax.profiler`` trace there)."""
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])
    prof = profile(activities=acts)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them for the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def hbm_bytes_per_s(name: str) -> float:
    """Published device-memory rate of the H100 variant ``name`` names."""
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12


def cuda_ms(fn: Callable[[], object], reps: int = 1) -> float:
    """Milliseconds a call of ``fn`` by CUDA events over ``reps`` back-to-back
    calls, after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_graph_ms(fn: Callable[[], object], reps: int = 20, replays: int = 10) -> float:
    """Device milliseconds a call of ``fn``: ``reps`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events after a
    warm-up call and a warm-up replay. The host's time to issue a call
    (argument checks, allocation, the launch) is not in the number, as it
    is in :func:`cuda_ms` once a call takes less device time than that."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def ptxas_usage(log: str) -> Dict[str, Tuple[int, int, int]]:
    """(registers, stack frame bytes, spill store bytes) of each kernel in
    an ``nvcc -Xptxas -v`` log, by mangled name."""
    usage, name, stack, spill = {}, None, 0, 0
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m:
            stack, spill = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name] = (int(m.group(1)), stack, spill)
            name, stack, spill = None, 0, 0
    return usage


def random_unit(kind: str, c_in: int, c_out: int, dtype: torch.dtype,
                gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """A folded ShuffleNet unit ("K1" or "K2", ``ops.shuffle``'s dict) on
    ``gen``'s device, with N(0, 1/fan_in) weights and N(0, 1) biases."""
    co2 = c_out // 2
    c1, mid = (c_in // 2, c_in // 2) if kind == "K1" else (c_in, co2)

    def rnd(*shape, fan=1):
        return (torch.randn(*shape, generator=gen, device=gen.device) / math.sqrt(fan)).to(dtype)
    return dict(k1=rnd(3, 3, c1, fan=9), b1=rnd(c1), w1=rnd(c1, co2, fan=c1), c1=rnd(co2),
                w2=rnd(c1, mid, fan=c1), c2=rnd(mid), k2=rnd(3, 3, mid, fan=9), b2=rnd(mid),
                w3=rnd(mid, co2, fan=mid), c3=rnd(co2))


def shuffle_unit_bound(kind: str, h: int, w: int, c_in: int, c_out: int, batch: int,
                       dtype: torch.dtype, name: str) -> Tuple[float, float]:
    """(ms by bytes, ms by operations) of one ShuffleNet unit ("K1" a
    bottleneck, "K2" a downsample) on [batch, h, w, c_in]: its input read
    once, its parameters read once and its output written once, over the
    memory rate of the card ``name``; both depthwise convolutions and the
    three pointwise products (2 operations a multiply-add) over the peak
    rate of the type."""
    es = torch.tensor([], dtype=dtype).element_size()
    co2, p_in = c_out // 2, batch * h * w
    if kind == "K1":
        ch, p_out = c_in // 2, p_in
        ops = 2 * p_in * (18 * ch + 2 * ch * co2 + ch * ch)
        params = 20 * ch + ch * ch + 2 * ch * co2 + 2 * co2
    else:
        p_out = p_in // 4
        ops = 2 * (p_out * (9 * c_in + 9 * co2 + co2 * co2) + (p_in + p_out) * c_in * co2)
        params = 10 * c_in + 10 * co2 + 2 * c_in * co2 + co2 * co2 + 3 * co2
    bytes_ = (p_in * c_in + p_out * c_out + params) * es
    peak = F32_PEAK_FLOPS if dtype == torch.float32 else BF16_PEAK_FLOPS
    return 1e3 * bytes_ / hbm_bytes_per_s(name), 1e3 * ops / peak


# per class of one posterior row (``ops.discrete_posterior``), in f32
# operations: the body's two max and two sum-exp passes, the clamps, the
# two log-add-exps and the selects, the score and the argmax (30); B7's
# Philox4x32-10 (40 integer operations a block of four classes) with the
# Gumbel transform's arithmetic (15); the top-r select as the function needs
# it (19): one order-preserving key a class (3) and an exact select by 8-bit
# digits, four passes of a prefix test, a digit and a count (4 each)
POSTERIOR_OPS, PHILOX_OPS, SELECT_OPS = 30, 15, 3 + 4 * 4
# transcendentals a class, on the SFU: B6's three expf and one log1pf; B7
# two logf more for the Gumbel transform
POSTERIOR_SFU, PHILOX_SFU = 4, 2
# the SFU issues 16 a clock an SM against the 128 f32 lanes (which
# F32_PEAK_FLOPS counts twice, a multiply-add being two operations)
SFU_PEAK_PER_S = F32_PEAK_FLOPS / 2 / 8


def posterior_bound(b: int, n: int, km1: int, dtype: torch.dtype, prng: bool, trunc_k: int,
                    name: str) -> Tuple[float, float]:
    """(ms by bytes, ms by operations) of one fused posterior-and-sample
    call on [b, n] rows of K = km1 + 1 classes. Bytes: the logits (and, for
    B6, the f32 Gumbel noise [b, n, K]) read once, the int64 carry read and
    the int64 indices written once, the [b, 10] f32 coefficients (and, for
    B7, the [b, 2] int32 seeds) read once, over the memory rate of the card
    ``name``. Operations: per class POSTERIOR_OPS, PHILOX_OPS for B7 and
    SELECT_OPS when trunc_k > 0 over the f32 peak, or POSTERIOR_SFU (B7
    PHILOX_SFU more) transcendentals over the SFU's rate, whichever is
    longer: the two pipes issue side by side."""
    es = torch.tensor([], dtype=dtype).element_size()
    k, rows = km1 + 1, b * n
    bytes_ = rows * (km1 * es + 16) + b * 40 + (b * 8 if prng else rows * k * 4)
    ops = rows * k * (POSTERIOR_OPS + (PHILOX_OPS if prng else 0) + (SELECT_OPS if trunc_k else 0))
    sfu = rows * k * (POSTERIOR_SFU + (PHILOX_SFU if prng else 0))
    return 1e3 * bytes_ / hbm_bytes_per_s(name), 1e3 * max(ops / F32_PEAK_FLOPS,
                                                           sfu / SFU_PEAK_PER_S)


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

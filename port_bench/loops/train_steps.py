"""``train_steps``: train steps of ``batch`` images on one card. Set-up
drives the first ``checked_steps`` steps through the same call and feed
and records what the check compares; the window closes at a step
boundary after a synchronise."""

from __future__ import annotations

from typing import Callable

import torch

from .. import trace as tracing
from . import Clock, one_card


def run(fam, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, setup_started: Callable[[], float], chips: int = 1) -> dict:
    one_card("train_steps", chips)
    side = fam.train_setup(cfg, traffic, seed, device)
    clock = Clock(side["device"])
    checked = traffic["checked_steps"]
    params = fam.leaves(side)
    p0 = {k: p.detach().clone() for k, p in params.items()}
    losses = []
    record: dict = {}
    for i in range(checked):
        losses.append(fam.train_step(side, i))
        if i == 0:
            record["grad"] = {k: fam.first_gradient(side, p).norm() for k, p in params.items()}
    record["delta"] = {k: (p.detach() - p0[k]).norm() for k, p in params.items()}
    ema = fam.ema_leaves(side)
    if ema is not None:
        record["ema_delta"] = {k: (e - p0[k]).norm() for k, e in ema.items()}
    del p0
    record = {k: {n: float(v) for n, v in d.items()} for k, d in record.items()}
    record["losses"] = [float(v) for v in losses]
    if trace:
        tracing.warm_up()
    clock.sync()
    setup_s = setup_started()
    if clock.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(clock.device)
    prof_first = checked + traffic["profile_after"] if trace else -1
    prof_last = prof_first + traffic["profile_steps"] - 1
    prof, stretch, trace_data = None, 0.0, None
    start = clock.now(sync=True)
    i = checked
    while True:
        if i == prof_first:
            prof = tracing.profiler()
            prof.__enter__()
            p0_t = clock.now(sync=True)
        fam.train_step(side, i)
        if i == prof_last:
            clock.sync()
            stretch = clock.now() - p0_t
            prof.__exit__(None, None, None)
            trace_data = tracing.read(prof)
            prof = None
        i += 1
        if prof is None and clock.now() - start >= seconds:
            break
    end = clock.now(sync=True)
    steps = i - checked
    window_s = end - start
    n_prof = traffic["profile_steps"] if trace else 0
    return {"setup_s": setup_s, "attempted": steps, "failed": 0,
            "train_images_per_s": traffic["batch"] * steps / window_s,
            "batch": traffic["batch"], "record": record, "side": side,
            "unprofiled_s": window_s - stretch, "unprofiled_steps": steps - n_prof,
            "trace": trace_data, "stretch_s": stretch}

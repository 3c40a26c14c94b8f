"""``serve_closed``: a closed loop of one client on one card. A request is
``images`` images sampled and decoded, copied to the host as uint8 by the
port's ``to_uint8``; every ``greedy_every``-th request is greedy, so that
its tokens can be judged by their logits. The window closes at the first
request boundary at or after the seconds, and not before the requests
whose images the check compares (drawn from the seed among the
configuration's first ``check_among``) are served. Every request of the
first ``check_among`` keeps its codes for the check."""

from __future__ import annotations

import random
import statistics
from typing import Callable, Dict, List

import torch

from .. import trace as tracing
from ..weights import derive
from . import Clock, one_card


def run(fam, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, setup_started: Callable[[], float], chips: int = 1) -> dict:
    from vq_vae_gan_diffusion_torch.utils import to_uint8

    one_card("serve_closed", chips)
    n, every = traffic["images"], traffic["greedy_every"]
    among = cfg["check_among"]
    chosen = set(random.Random(derive(seed, "check")).sample(range(among),
                                                              cfg["check_requests"]))
    side = fam.serve_setup(cfg, traffic, seed, device)
    clock = Clock(side["device"])
    fam.serve_warmup(side, n)
    if trace:
        tracing.warm_up()
    clock.sync()
    setup_s = setup_started()
    if clock.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(clock.device)
    prof_first = traffic["profile_after"] if trace else -1
    prof_last = prof_first + traffic["profile_requests"] - 1
    lat: List[float] = []
    by_kind: Dict[str, List[float]] = {"greedy": [], "sampled": []}
    phases: Dict[str, List[float]] = {"sample": [], "decode": []}
    kept: List[dict] = []
    prof, stretch, trace_data, profiled = None, 0.0, None, set()
    start = clock.now(sync=True)
    i = 0
    while True:
        greedy = i % every == every - 1
        if i == prof_first:
            prof = tracing.profiler()
            prof.__enter__()
            p0 = clock.now(sync=True)
        inputs = fam.serve_inputs(side, i, greedy)
        t0 = clock.now()
        codes = fam.serve_sample(side, n, inputs)
        t1 = clock.now(sync=trace)
        imgs = fam.serve_decode(side, codes)
        t2 = clock.now(sync=trace)
        host = to_uint8(imgs.detach().float().cpu().numpy(), cfg["mean"], cfg["std"])
        t3 = clock.now()
        del host
        lat.append(t3 - t0)
        by_kind["greedy" if greedy else "sampled"].append(t3 - t0)
        if i == prof_last:
            clock.sync()
            stretch = clock.now() - p0
            prof.__exit__(None, None, None)
            trace_data = tracing.read(prof)
            prof = None
        if prof_first <= i <= prof_last:
            profiled.add(i)
        else:
            phases["sample"].append(t1 - t0)
            phases["decode"].append(t2 - t1)
        if i < among:
            kept.append({"i": i, "greedy": greedy, "given": inputs.get("given", 0),
                         "codes": codes, "images": imgs if i in chosen else None})
        i += 1
        if t3 - start >= seconds and prof is None and i > max(chosen):
            break
    window_s = t3 - start
    return {"setup_s": setup_s, "attempted": i, "failed": 0,
            "serve_images_per_s": n * i / window_s,
            "serve_p90_s": (statistics.quantiles(lat, n=10, method="inclusive")[-1]
                            if len(lat) > 1 else lat[0]),
            "phases": phases, "images_per_request": n,
            "request_s_median": {k: statistics.median(v) for k, v in by_kind.items() if v},
            "unprofiled_s": sum(l for k, l in enumerate(lat) if k not in profiled),
            "unprofiled_requests": i - len(profiled), "kept": kept, "side": side,
            "trace": trace_data, "stretch_s": stretch}

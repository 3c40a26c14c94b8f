"""The readings that a cell's limits are set from, in one process on the
card: the program's numbers on each seed (a short window at the cell's own
load), the control's (the plain reference in TF32, the nearest precision
below the configurations' float32, put in the program's place) and, for a
training cell, the fault of half the batch left out.

    python3 -m port_bench.calibrate --workload <cell> --seeds 11,12,13 \
        [--control-seeds 11,12,13] [--faults half_batch] [--seconds 5]

Prints one JSON line a reading and a last line with each number's largest
sound reading and smallest control and fault readings. Not run by the
benchmark's runs; ``tests/test_port_bench_card.py`` drives it on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Dict, List, Optional

import torch

from .run import Bench, _free, compare, process_seconds


@contextlib.contextmanager
def half_batch():
    """Each train step sees the first half of its batch and of its draws,
    the loss the mean over those rows alone."""
    import vq_vae_gan_diffusion_torch.train.vq_diffusion_worker as vd
    import vq_vae_gan_diffusion_torch.train.vq_transformer_worker as vt

    saved = {c: c.train_step for c in (vd.VQDiffusionWorker, vt.VQTransformerWorker)}

    def wrap(orig):
        def step(self, state, batch, generator=None, **draws):
            h = batch.shape[0] // 2
            return orig(self, state, batch[:h], generator,
                        **{k: v[:h] for k, v in draws.items()})
        return step
    for c, orig in saved.items():
        c.train_step = wrap(orig)
    try:
        yield
    finally:
        for c, orig in saved.items():
            c.train_step = orig


def readings(bench: Bench, cell_name: str, seed: int, seconds: float, control: bool,
             fault: Optional[str], device: str = "cuda", config: Optional[dict] = None
             ) -> Dict[str, Dict[str, float]]:
    """One run of the cell's loop on ``seed`` (with ``fault`` planted) and
    its numbers: ``sound`` (or the fault's name) and, with ``control``,
    the control's at the same run."""
    cell = bench.cell(cell_name)
    cfg = config or bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    fam = bench.family(cfg)
    dev = torch.device(device)
    ctx = half_batch() if fault == "half_batch" else contextlib.nullcontext()
    with ctx:
        res = bench.loop(traffic)(fam, cfg, traffic, seed, seconds, False, dev,
                                  process_seconds, chips=cell["chips"])
    out = {fault or "sound": compare(fam, cfg, traffic, seed, res, dev)}
    if control:
        out["control"] = compare(fam, cfg, traffic, seed, res, dev, control=True)
    _free(dev)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    bench = Bench()
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    faults = [f for f in args.faults.split(",") if f]
    summary: Dict[str, Dict[str, float]] = {}
    runs = [(s, None) for s in seeds] + [(s, f) for f in faults for s in sorted(control)]
    for seed, fault in runs:
        t0 = time.perf_counter()
        got = readings(bench, args.workload, seed, args.seconds,
                       fault is None and seed in control, fault)
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t0, **got}), flush=True)
        for kind, nums in got.items():
            for name, v in nums.items():
                if v is None:
                    continue
                s = summary.setdefault(kind, {})
                s[name] = max(s.get(name, v), v) if kind == "sound" else min(s.get(name, v), v)
    print(json.dumps({"workload": args.workload, "card": torch.cuda.get_device_name(0),
                      "largest_sound_smallest_other": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of ``BENCHMARK.json`` once and print its result as the last
line of standard output.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``vq_vae_gan_diffusion_torch``).
The cell names a configuration and a traffic mix; the configuration's file
names its family (``families/<family>.py``), the traffic file its kind
(``loops/<kind>.py``), and the cell its count of cards. With ``--trace 0`` the line carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, each from the reader
``metrics/<name>.py``. After the window the program's state is freed and
the plain reference decides ``correct``; each number compared is printed
beside its limit, as the last lines of standard error and under ``checks``,
the line's last key.

Exits 2 without a result where no CUDA card is visible or fewer than the
cell asks for, and 3 where a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "vq_vae_gan_diffusion_tpu")


def process_seconds() -> float:
    """Seconds since this process started, from the kernel's record of its
    start (falls back to the time this module was loaded)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _LOADED


_LOADED = time.perf_counter()


def load_file(path: Path, base: Path = BENCH_DIR) -> ModuleType:
    """The Python file ``path`` under the benchmark's folder ``base`` as a
    module: a family as ``port_bench.families.<name>`` (it imports its
    package's modules relatively), a metric's reader under a name made from
    its file name (a metric's name may hold dots)."""
    rel = path.relative_to(base).with_suffix("")
    name = "port_bench." + ".".join(rel.parts)
    if rel.parts[0] == "metrics":
        name = "port_bench.metrics." + re.sub(r"\W", "_", rel.name)
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


class Bench:
    """``BENCHMARK.json`` and the files it names, found under ``root``."""

    def __init__(self, root: Path = ROOT, bench_dir: Path = BENCH_DIR):
        self.root, self.dir = root, bench_dir
        self.spec = json.loads((root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.spec["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def family(self, cfg: dict) -> ModuleType:
        return load_file(self.dir / "families" / f"{cfg['family']}.py", self.dir)

    def loop(self, traffic: dict):
        """The ``run`` of the traffic's kind, ``loops/<kind>.py``."""
        return load_file(self.dir / "loops" / f"{traffic['kind']}.py", self.dir).run

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.spec["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell]) and m["moves"] in reported]

    def reader(self, metric: str) -> ModuleType:
        return load_file(self.dir / "metrics" / f"{metric}.py", self.dir)


def card() -> Dict[str, object]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import torch

    info = {"kind": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        info["power_limit"] = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        info["power_limit"] = "unread"
    return info


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(bench: Bench, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", config: Optional[dict] = None) -> dict:
    """Run the cell once and return the result line as a dict (without
    printing). ``config`` replaces the cell's configuration (the tests' tiny
    sizes); ``device`` is the card or, in the tests, the CPU."""
    import torch

    cell = bench.cell(workload)
    cfg = config or bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    fam = bench.family(cfg)
    dev = torch.device(device)
    res = bench.loop(traffic)(fam, cfg, traffic, seed, seconds, trace, dev, process_seconds,
                              chips=cell["chips"])
    # a kind that runs its ranks in processes of their own reports their peak itself
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    info = card() if dev.type == "cuda" else {"kind": "cpu", "power_limit": "none"}
    device_line = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": info["kind"],
                   "count": cell["chips"], "memory_peak_bytes": int(peak),
                   "power_limit": info["power_limit"]}
    metrics: Dict[str, dict] = {}
    line: dict = {"correct": False, "attempted": res["attempted"], "failed": res["failed"]}
    tr = res["trace"] if trace else None
    if tr is not None:
        from . import trace as tracing

        device_line["busy_s"] = tracing.busy_seconds(tr)
        device_line["window_s"] = res["stretch_s"]
        line["breakdown"] = tracing.breakdown(tr)
    device_line.update(res.get("device", {}))
    if trace:
        ctx = {"cell": cell, "config": cfg, "traffic": traffic, "family": fam, "result": res,
               "trace": tr, "device": device_line}
        for m in bench.per_layer(workload):
            value = bench.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench.end_to_end(workload):
            metrics[m["name"]] = {"value": res[m["name"]], "unit": m["unit"]}
    if "request_s_median" in res:
        print("port_bench: request seconds, median by kind: " + ", ".join(
            f"{k} {v!r}" for k, v in res["request_s_median"].items()), file=sys.stderr)
    checks = check(fam, cfg, traffic, seed, res, dev)
    line.update(correct=all(c["value"] is not None and c["value"] <= c["limit"]
                            for c in checks.values()),
                metrics=metrics, device=device_line, checks=checks)
    return line


def compare(fam, cfg: dict, traffic: dict, seed: int, res: dict, dev,
            control: bool = False) -> Dict[str, Optional[float]]:
    """Free the program's state, run the plain reference and return each
    number compared. With ``control``, the numbers of the reference in
    TF32 put in the program's place (at the program's served tokens)."""
    import torch

    from .families.common import training_readings

    res.pop("side", None)
    if "record" in res:
        _free(dev)
        ref = fam.reference_train(cfg, traffic, seed, dev, traffic["checked_steps"])
        prog = (fam.reference_train(cfg, traffic, seed, dev, traffic["checked_steps"],
                                    control=True) if control else res["record"])
        return dict(training_readings(prog, ref))
    res["kept"] = [{k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in r.items()}
                   for r in res["kept"]]
    _free(dev)
    return dict(fam.serve_check(cfg, seed, res["kept"], dev, control=control))


def check(fam, cfg: dict, traffic: dict, seed: int, res: dict, dev) -> Dict[str, dict]:
    """Each number compared beside its limit from the configuration."""
    started = time.perf_counter()
    readings = compare(fam, cfg, traffic, seed, res, dev)
    print(f"port_bench: the reference took {time.perf_counter() - started:.1f} s",
          file=sys.stderr)
    return {name: {"value": v, "limit": cfg["limits"][name]} for name, v in readings.items()}


def _free(dev) -> None:
    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    bench = Bench()
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"port_bench: the cell {args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    line = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"port_bench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The card's idle gaps charged to the program's spans: the gaps between
device activity, taken as :func:`port_bench.trace.breakdown` takes them,
each charged to the spans of the program (``torch.profiler`` annotations
named in ``SPANS``) that cover its middle; aten operations are left out.
A trace of a program without spans gives every reader ``None``."""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

from port_bench.trace import _union

# The span names of vq_vae_gan_diffusion_torch.utils.tracing.SPANS, written
# out: the harness reads the trace of a program that may predate them.
SPANS = ("gpt.sample", "gpt.position", "gaussian3d.chain", "gaussian3d.step",
         "gaussian3d.readout", "vqgan.encode", "vqgan.decode", "serve.request", "train.step",
         "train.forward", "train.backward", "train.optimizer")


def gaps(trace: dict) -> Dict[Tuple[str, ...], float]:
    """Idle seconds between device activity by the spans covering each
    gap's middle, outermost first (``()``: under no span)."""
    busy = _union(trace["device"])
    spans = sorted((s for s in trace["host"] if s[0] in SPANS), key=lambda s: (s[1], -s[2]))
    out: Dict[Tuple[str, ...], float] = {}
    active: list = []
    j = 0
    for (_, end), (start, _) in zip(busy[:-1], busy[1:]):
        mid = (end + start) / 2
        while j < len(spans) and spans[j][1] <= mid:
            active.append(spans[j])
            j += 1
        active = [s for s in active if s[2] >= mid]
        key = tuple(s[0] for s in active)
        out[key] = out.get(key, 0.0) + (start - end) / 1e6
    return out


def idle_under(ctx, span: str, unit: str, exclude: Iterable[str] = ()) -> Optional[float]:
    """Idle seconds under ``span`` and under none of ``exclude``, a ``unit``
    span of the profiled stretch; None without a trace or a ``unit`` span."""
    trace = ctx["trace"]
    if trace is None:
        return None
    units = sum(s[0] == unit for s in trace["host"])
    if not units:
        return None
    exclude = set(exclude)
    return sum(v for k, v in gaps(trace).items()
               if span in k and not exclude.intersection(k)) / units

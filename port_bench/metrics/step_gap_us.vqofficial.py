"""step_gap_us.vqofficial: microseconds the card is idle a reverse step of the
VQ_Official chain: the idle gaps between device activity whose middle lies
under one of the program's ``discrete.step`` spans, over their count. A
gap is charged as ``span_idle.gaps`` charges it, whose list of spans
predates the discrete chain's."""

import bisect

from port_bench.trace import _union

SPAN = "discrete.step"


def read(ctx):
    trace = ctx["trace"]
    if trace is None:
        return None
    steps = sorted((a, b) for name, a, b in trace["host"] if name == SPAN)
    if not steps:
        return None
    starts = [a for a, _ in steps]
    busy = _union(trace["device"])
    idle = 0.0
    for (_, end), (start, _) in zip(busy[:-1], busy[1:]):
        mid = (end + start) / 2
        j = bisect.bisect_right(starts, mid) - 1
        if j >= 0 and steps[j][1] >= mid:
            idle += start - end
    return idle / len(steps)

"""device_idle_pct.serve: the card's idle share of the profiled stretch of a
serve cell, in % (:mod:`.device_idle`)."""

from port_bench.metrics.device_idle import idle


def read(ctx):
    return idle(ctx)

"""device_idle_pct.train: the card's idle share of the profiled stretch of a
train cell, in % (:mod:`.device_idle`)."""

from port_bench.metrics.device_idle import idle


def read(ctx):
    return idle(ctx)

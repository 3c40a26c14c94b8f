"""step_gap_us.gaussian3d: microseconds the card is idle a reverse step of
the gaussian3d chain, the idle gaps under the program's ``gaussian3d.step``
spans over their count (:mod:`.span_idle`)."""

from port_bench.metrics.span_idle import idle_under


def read(ctx):
    s = idle_under(ctx, "gaussian3d.step", "gaussian3d.step")
    return None if s is None else 1e6 * s

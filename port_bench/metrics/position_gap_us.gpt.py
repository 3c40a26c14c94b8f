"""position_gap_us.gpt: microseconds the card is idle a position of the GPT's
sampling loop, the idle gaps under the program's ``gpt.position`` spans
over their count (:mod:`.span_idle`)."""

from port_bench.metrics.span_idle import idle_under


def read(ctx):
    s = idle_under(ctx, "gpt.position", "gpt.position")
    return None if s is None else 1e6 * s

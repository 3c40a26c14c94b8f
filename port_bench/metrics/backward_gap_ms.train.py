"""backward_gap_ms.train: milliseconds the card is idle a train step under
``train.backward`` (zero_grad, the backward, the gradients' reduction), over
the count of ``train.step`` spans (:mod:`.span_idle`)."""

from port_bench.metrics.span_idle import idle_under


def read(ctx):
    s = idle_under(ctx, "train.backward", "train.step")
    return None if s is None else 1e3 * s

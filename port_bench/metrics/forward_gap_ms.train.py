"""forward_gap_ms.train: milliseconds the card is idle a train step under
``train.forward`` (the composite's forward and the loss), outside its
``vqgan.encode``, over the count of ``train.step`` spans
(:mod:`.span_idle`)."""

from port_bench.metrics.span_idle import idle_under


def read(ctx):
    s = idle_under(ctx, "train.forward", "train.step", exclude=("vqgan.encode",))
    return None if s is None else 1e3 * s

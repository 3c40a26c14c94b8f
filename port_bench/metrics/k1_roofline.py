"""k1_roofline: kernel K1's (the ShuffleNet bottleneck unit's) share of its
roofline, in %, over a traced request of the gaussian3d chain."""

from port_bench.metrics.shuffle_roofline import share


def read(ctx):
    return share(ctx, "K1")

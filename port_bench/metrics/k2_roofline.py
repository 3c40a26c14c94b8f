"""k2_roofline: kernel K2's (the ShuffleNet downsample unit's) share of its
roofline, in %, over a traced request of the gaussian3d chain."""

from port_bench.metrics.shuffle_roofline import share


def read(ctx):
    return share(ctx, "K2")

"""k1_roofline.vqofficial: kernel K1's (the ShuffleNet bottleneck unit's)
share of its roofline, in %, over a traced request of the VQ_Official
chain, at that U-Net's unit shapes (:mod:`.discrete_unet`)."""

from port_bench.metrics.discrete_unet import share


def read(ctx):
    return share(ctx, "K1")

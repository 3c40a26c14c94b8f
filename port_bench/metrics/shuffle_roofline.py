"""The share of its roofline of one ShuffleNet kernel of the gaussian3d
U-Net (K1 ``bottleneck_kernel``, K2 ``downsample_kernel``), in %: the least
time of one U-Net forward's units of that kind (``yardstick.
shuffle_unit_bound``, the larger of bytes and operations) times the
forwards in the trace, over the kernel's summed device time. The profiled
stretch holds whole forwards."""

from port_bench.trace import kernel_seconds
from port_bench.yardstick import shuffle_unit_bound, unet_sizes, unet_unit_shapes

KERNELS = {"K1": "bottleneck_kernel", "K2": "downsample_kernel"}


def share(ctx, kind: str):
    if ctx["trace"] is None:
        return None
    seconds, launches = kernel_seconds(ctx["trace"], KERNELS[kind])
    cfg = ctx["config"]
    u = unet_sizes(cfg)
    units = [s for s in unet_unit_shapes(cfg["vqvae"]["latent_size"] ** 2,
                                         cfg["vqdiffusion"]["gaussian_dim"], u["base_dim"],
                                         u["dim_mults"])
             if s[0] == kind]
    if not launches or launches % len(units):
        return None
    b = ctx["traffic"]["images"]
    bound_s = sum(max(shuffle_unit_bound(kind, h, w, ci, co, b, cfg["dtype"],
                                         ctx["device"]["kind"])) for kind, h, w, ci, co in units)
    return 100.0 * (launches // len(units)) * bound_s / 1e3 / seconds

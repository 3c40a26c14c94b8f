"""The share of its roofline of one ShuffleNet kernel (K1
``bottleneck_kernel``, K2 ``downsample_kernel``) of the VQ_Official U-Net,
in %: the least time of one U-Net forward's units of that kind
(``yardstick.shuffle_unit_bound``, the larger of bytes and operations) on
the [B, K, N, 1] log-probability image at the traffic's batch, times the
forwards in the trace, over the kernel's summed device time. The profiled
stretch holds whole forwards."""

from port_bench.metrics.shuffle_roofline import KERNELS
from port_bench.trace import kernel_seconds
from port_bench.yardstick import shuffle_unit_bound, unet_sizes, unet_unit_shapes


def units(cfg: dict, kind: str) -> list:
    """(kernel, H, W, C_in, C_out) of the forward's units of ``kind``."""
    u = unet_sizes(cfg)
    grid = (cfg["vqvae"]["num_codebook_vectors"], cfg["vqvae"]["latent_size"] ** 2)
    return [s for s in unet_unit_shapes(*grid, u["base_dim"], u["dim_mults"]) if s[0] == kind]


def share(ctx, kind: str):
    if ctx["trace"] is None:
        return None
    seconds, launches = kernel_seconds(ctx["trace"], KERNELS[kind])
    shapes = units(ctx["config"], kind)
    if not launches or launches % len(shapes):
        return None
    b, dtype, card = ctx["traffic"]["images"], ctx["config"]["dtype"], ctx["device"]["kind"]
    bound_ms = sum(max(shuffle_unit_bound(kind, h, w, ci, co, b, dtype, card))
                   for _, h, w, ci, co in shapes)
    return 100.0 * (launches // len(shapes)) * bound_ms / 1e3 / seconds

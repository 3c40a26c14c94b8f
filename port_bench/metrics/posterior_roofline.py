"""posterior_roofline: kernel B6's (the fused posterior-and-sample step's)
share of its roofline, in %: the least time of a call
(``port_bench.posterior_bound``, the larger of bytes and operations, at the
traffic's batch over the configuration's positions and classes) times its
launches, over the summed device time of ``posterior_kernel`` in the
trace."""

from port_bench.posterior_bound import posterior_bound
from port_bench.trace import kernel_seconds


def read(ctx):
    if ctx["trace"] is None:
        return None
    seconds, launches = kernel_seconds(ctx["trace"], "posterior_kernel")
    if not launches:
        return None
    cfg = ctx["config"]
    vq = cfg["vqvae"]
    bound_ms = max(posterior_bound(ctx["traffic"]["images"], vq["latent_size"] ** 2,
                                   vq["num_codebook_vectors"] - 1, cfg["dtype"],
                                   ctx["device"]["kind"]))
    return 100.0 * launches * bound_ms / 1e3 / seconds

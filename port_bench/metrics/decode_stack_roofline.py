"""decode_stack_roofline: kernel B1's share of its roofline, in %: the
least time of its calls (``yardstick.decode_stack_bound_ms``, averaged over
a request's positions, times the launches) over the summed device time of
``decode_stack_kernel`` in the trace. The profiled stretch holds whole
requests, so the launches cover every position alike."""

from port_bench.trace import kernel_seconds
from port_bench.yardstick import decode_stack_bound_ms


def read(ctx):
    if ctx["trace"] is None:
        return None
    seconds, launches = kernel_seconds(ctx["trace"], "decode_stack_kernel")
    if not launches:
        return None
    cfg, g = ctx["config"], ctx["config"]["vqvae_transformer"]
    positions = ctx["family"].steps_per_request(cfg)
    bound_ms, _ = decode_stack_bound_ms(cfg["dtype"], ctx["device"]["kind"], g["n_layer"],
                                        ctx["traffic"]["images"], g["n_embd"], positions)
    return 100.0 * launches * bound_ms / 1e3 / seconds

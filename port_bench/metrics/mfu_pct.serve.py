"""mfu_pct.serve: a request's model operations, counted from the
configuration's shapes (``family.request_flops``), over its time at the
card's published peak for the configuration's type, in %: the traced run's
requests outside the profiled stretch."""

from port_bench.yardstick import peak_flops


def read(ctx):
    res, cfg = ctx["result"], ctx["config"]
    if not res["unprofiled_requests"]:
        return None
    flops = ctx["family"].request_flops(cfg, res["images_per_request"])
    return 100.0 * flops * res["unprofiled_requests"] / res["unprofiled_s"] / \
        peak_flops(cfg["dtype"])

"""mfu_pct.train: a train step's model operations, counted from the
configuration's shapes (``family.step_flops``: the frozen encoder's forward,
the prior's forward and backward, no optimizer), over its time at the
card's published peak for the configuration's type (TF32 is off), in %:
the traced run's steps outside the profiled stretch."""

from port_bench.yardstick import peak_flops


def read(ctx):
    res, cfg = ctx["result"], ctx["config"]
    if not res["unprofiled_steps"]:
        return None
    flops = ctx["family"].step_flops(cfg, res["batch"])
    return 100.0 * flops * res["unprofiled_steps"] / res["unprofiled_s"] / \
        peak_flops(cfg["dtype"])

"""The share of the profiled stretch in which no operation ran on the card,
in %, from the device trace's kernel, copy and set activity."""


def idle(ctx):
    dev = ctx["device"]
    if ctx["trace"] is None or not dev.get("window_s"):
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])

"""reverse_step_ms.vqofficial: milliseconds a reverse step of the VQ_Official
chain (``diffusion/discrete.DiscreteDiffusion.sample``), the sample phase of
a request over its steps, the device synchronised around it."""


def read(ctx):
    times = ctx["result"].get("phases", {}).get("sample")
    if not times:
        return None
    return 1e3 * sum(times) / len(times) / ctx["family"].steps_per_request(ctx["config"])

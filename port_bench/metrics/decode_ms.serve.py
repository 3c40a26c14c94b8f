"""decode_ms.serve: milliseconds a request spends in the stage-1 decoder
(``composite.z_to_image`` -> ``VQVAE.decode_indices``), the device
synchronised around the phase, averaged over the traced run's requests
outside the profiled stretch."""


def read(ctx):
    times = ctx["result"].get("phases", {}).get("decode")
    return 1e3 * sum(times) / len(times) if times else None

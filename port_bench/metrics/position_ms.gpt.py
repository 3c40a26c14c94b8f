"""position_ms.gpt: milliseconds a position of the GPT's sampling loop
(``models/mingpt.sample_tokens``), the sample phase of a request over its
positions, the device synchronised around the phase."""


def read(ctx):
    times = ctx["result"].get("phases", {}).get("sample")
    if not times:
        return None
    return 1e3 * sum(times) / len(times) / ctx["family"].steps_per_request(ctx["config"])

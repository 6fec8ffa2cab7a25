"""``ttft_p95_ms``: the 95th percentile (nearest rank) of time to first
token over every request submitted in the window, those drained after it
included: submission to the first token on the host, ms."""

import math


def read(run):
    if run.kind != "prefill":
        return None
    waits = sorted(run.window["ttft_s"])
    return 1e3 * waits[math.ceil(0.95 * len(waits)) - 1]

"""ttft_p95_s (s, host clock): the nearest-rank 95th percentile, over
every request the window finished, of the time from the request's issue
to its first token on the host (``ServeEngine.prefill``'s return)."""
from portbench import window


def read(ctx):
    if ctx.traffic["kind"] != "prefill" or not ctx.requests:
        return None
    return window.percentile(window.ttft(ctx.requests), 95)

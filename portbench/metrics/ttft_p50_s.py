"""ttft_p50_s (s, host clock; engine layer): the median, over every
request the window finished, of the time from issue to first token."""
from portbench import window


def read(ctx):
    if ctx.traffic["kind"] != "prefill" or not ctx.requests:
        return None
    return window.percentile(window.ttft(ctx.requests), 50)

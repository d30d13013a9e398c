"""prompt_tokens_per_s (tokens/s, host clock): the prompt tokens of every
request whose first token reached the host in the window, over the
window's seconds, gaps included."""
from portbench import window


def read(ctx):
    if ctx.traffic["kind"] != "prefill" or not ctx.requests:
        return None
    return window.rate([r["prompt_len"] * r["rows"] for r in ctx.requests],
                       ctx.window_s)

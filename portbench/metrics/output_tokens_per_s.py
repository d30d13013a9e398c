"""output_tokens_per_s (tokens/s, host clock): the generated tokens that
reached the host in the window (each batch's first token at its
prefill's return, then a decode chunk's at a time), over the window's
seconds; each batch's prefill counts in the time."""
from portbench import window


def read(ctx):
    if ctx.traffic["kind"] != "decode" or not ctx.requests:
        return None
    return window.rate([r["tokens_out"] for r in ctx.requests],
                       ctx.window_s)

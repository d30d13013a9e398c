"""decode_step_ms (ms, host clock around every decode chunk; engine
layer): the chunks' total time over their total steps."""


def read(ctx):
    steps = sum(c["steps"] for c in ctx.chunks)
    if not steps:
        return None
    return 1e3 * sum(c["t1"] - c["t0"] for c in ctx.chunks) / steps

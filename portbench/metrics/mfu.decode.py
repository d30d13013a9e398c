"""mfu.decode (%, model step): the whole decode step's roofline share
over the traced stretch of decode chunks: each step's least time (the
larger of its model operations over the bf16 peak and the bytes it must
move over the memory bandwidth, ``work/model.py``; bytes bound it) summed
over the stretch's steps, over the stretch's seconds."""
from portbench.work import model


def read(ctx):
    chunks = [c for c in ctx.chunks if c["stretch"]]
    if ctx.trace is None or not chunks:
        return None
    least = sum(model.decode_least_seconds(ctx.cfg, c["rows"], c["pos"],
                                           c["steps"]) for c in chunks)
    return 100.0 * least / ctx.trace.window_s

"""mfu.prefill (%, model step): the model operations of the traced
stretch's prompts (``work/model.py``) over the stretch's seconds times
the bf16 peak."""
from portbench.work import model, peaks


def read(ctx):
    reqs = [r for r in ctx.requests if r["stretch"]]
    if ctx.trace is None or not reqs:
        return None
    flops = sum(model.prefill_flops(ctx.cfg, r["rows"], r["prompt_len"])
                for r in reqs)
    return 100.0 * flops / (ctx.trace.window_s * peaks.BF16_FLOPS)

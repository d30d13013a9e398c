"""idle_share.prefill (%, device): the share of the traced stretch of
prefill requests in which no kernel, copy or fill ran on the card."""
from portbench.trace import idle_percent


def read(ctx):
    return idle_percent(ctx, "prefill")

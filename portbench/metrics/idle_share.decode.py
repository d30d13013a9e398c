"""idle_share.decode (%, device): the share of the traced stretch of
decode chunks in which no kernel, copy or fill ran on the card."""
from portbench.trace import idle_percent


def read(ctx):
    return idle_percent(ctx, "decode")

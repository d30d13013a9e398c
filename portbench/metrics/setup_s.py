"""setup_s (s, host clock): from the process's start to the window's
start: imports, the card's start-up, the kernels' load (their build in
a checkout's first run), the weights made from the seed, the warm-up."""


def read(ctx):
    return ctx.setup_s

"""``setup_s``: process start to the window's start (host clock): the
imports, the data from the seed, the program's graph index, its plans
and the warm-up batches."""


def read(ctx):
    return ctx.setup_s

"""``samples_per_s``: samples of every request answered in the window,
over the window's whole time (host clock).  A sample drawn once and
counted for several motifs counts once for each request that asked for
it: that sharing is what the user gains."""


def read(ctx):
    done = [r["result"].k for r in ctx.records if r["result"] is not None]
    return sum(done) / ctx.window_s if done else None

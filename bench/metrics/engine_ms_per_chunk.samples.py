"""``engine_ms_per_chunk.samples``: the program's ``engine.dispatch``
spans (one per cohort window, each ending in the window's host copy)
over the chunks they dispatched, in the traced window less the profiled
slice, whose launches the profiler slows."""


def in_slice(ctx, t0: float) -> bool:
    s = ctx.slice
    return s is not None and s.host_t0 <= t0 <= s.host_t0 + s.wall_s


def read(ctx):
    spans = [(d, a) for t0, d, name, a in ctx.spans()
             if name == "engine.dispatch" and t0 >= ctx.window_t0
             and not in_slice(ctx, t0)]
    chunks = sum(a["n"] for _, a in spans)
    return 1e3 * sum(d for d, _ in spans) / chunks if chunks else None

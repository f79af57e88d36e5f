"""``validate_idle.samples``: the share of the profiled slice in which
the host is inside a ``validate.lane`` span (launching a lane's torch
ops) while no device operation runs: validation's launches starving the
card.  Host spans and device intervals are compared on the profiler's
clock (the spans' ``ts_ns``); the slice's bounds come through the
program's conversion of ``perf_counter`` (``obs.clock.profiler_ns``)."""
from bench.yardstick import stages


def read(ctx):
    s = ctx.slice
    lanes = [r for r in stages.records("validate.lane") if "ts_ns" in r]
    if s is None or not s.device or not lanes:
        return None
    start, end = stages.slice_bounds_ns(s)
    host = stages.union(
        (max(start, r["ts_ns"]), min(end, r["ts_ns"]
                                     + round(r["dur_s"] * 1e9)))
        for r in lanes)
    if not host:
        return None
    idle = (sum(b - a for a, b in host)
            - stages.overlap(host, s.union()))
    return 100.0 * idle / (end - start)

"""The program's own stage records, for the per-layer readers.

At ``obs`` level ``trace`` the program records spans in its flight
recorder (``repro_torch.obs.RECORDER``): per chunk of an engine window
``sampler.draw`` and one ``validate.lane`` a count lane, each with
``device_ms`` (a pair of CUDA timing events) on a card; per weight-DP
candidate ``planner.weights``;
per ``nvcc`` batch ``kernels.build``.  Every record carries ``t0``
(``perf_counter`` s) and, where the program has the shared clock,
``ts_ns``, its start on the profiler's clock.

Readers built on these return ``None`` where the records are absent: a
program without these spans, or ``device_ms`` on a CPU run.
"""
from __future__ import annotations


def records(name: str | None = None) -> list:
    """The program's records named ``name`` (all of them for None)."""
    from repro_torch import obs
    return [r for r in obs.RECORDER.records()
            if name is None or r["name"] == name]


def in_slice(ctx, t0: float) -> bool:
    """Whether ``t0`` (perf_counter s) falls in the profiled slice."""
    s = ctx.slice
    return s is not None and s.host_t0 <= t0 <= s.host_t0 + s.wall_s


def window_device_ms(ctx, name: str) -> list:
    """``device_ms`` of the ``name`` records opened in the measured
    window outside the profiled slice, whose launches CUPTI slows."""
    t_w = getattr(ctx, "window_t0", None)
    if t_w is None:
        return []
    return [r["device_ms"] for r in records(name)
            if "device_ms" in r and r["t0"] >= t_w
            and not in_slice(ctx, r["t0"])]


def mean(xs: list) -> float | None:
    return sum(xs) / len(xs) if xs else None


def slice_bounds_ns(s) -> tuple:
    """The profiled slice's start and end on the profiler's clock,
    through the program's own conversion of ``perf_counter``."""
    from repro_torch.obs import clock
    start = clock.profiler_ns(s.host_t0)
    return start, start + round(s.wall_s * 1e9)


def union(intervals) -> list:
    """Sorted, disjoint ``[a, b]`` covering the non-empty intervals."""
    out = []
    for a, b in sorted(iv for iv in intervals if iv[1] > iv[0]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap(xs: list, ys: list) -> int:
    """Length of the intersection of two sorted, disjoint interval
    lists."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total

"""One profiled slice of a run: the device's kernels and idle gaps.

``capture(fn)`` runs ``fn()`` under ``torch.profiler`` with CUDA
activity only (kernels, copies and the host's CUDA runtime calls, all
through CUPTI; host op events would take minutes to gather over a slice
of ~10^5 launches) and keeps, from the raw event list, every device
activity and every runtime call with its start and end in nanoseconds.
``Slice`` reduces them:

* ``busy_s``: the union of the device intervals (overlaps counted once);
* ``idle_share``: 1 - busy / the slice's host-clock length;
* ``device_ops``: device seconds by kernel name, most first;
* ``idle_gaps``: every gap between busy intervals, labelled by what the
  host was doing at its middle: the innermost recorded host span (the
  program's ``obs`` spans and the benchmark's own) and the CUDA runtime
  call in progress, if any.  Host spans use ``perf_counter``; the
  profiler's clock is mapped onto it by the first runtime call, which
  follows the slice's start by microseconds.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass

import torch


@dataclass
class Slice:
    wall_s: float
    host_t0: float                 # perf_counter at the slice's start
    device: list                   # (start_ns, end_ns, name), start order
    runtime: list                  # (start_ns, end_ns, name)
    offset_ns: int = 0             # profiler ns - perf_counter ns

    def kernels(self, part: str | None = None) -> list:
        return [d for d in self.device
                if part is None or part in d[2]]

    def union(self) -> list:
        out = []
        for s, e, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.union()) / 1e9

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.wall_s

    def device_ops(self, top: int = 10) -> list:
        by = defaultdict(float)
        for s, e, name in self.device:
            by[name[:96]] += (e - s) / 1e9
        return sorted(([n, v] for n, v in by.items()),
                      key=lambda x: -x[1])[:top]

    def idle_gaps(self, spans: list, top: int = 10) -> list:
        """Idle seconds by host activity: ``[label, seconds]``, most
        first; ``spans`` are ``(t0_s, dur_s, name)`` on perf_counter."""
        u = self.union()
        t_start = int(self.host_t0 * 1e9) + self.offset_ns
        t_end = t_start + int(self.wall_s * 1e9)
        edges = [t_start] + [x for iv in u for x in iv] + [t_end]
        host = [h for h in ((int(t0 * 1e9) + self.offset_ns,
                             int((t0 + d) * 1e9) + self.offset_ns, name)
                            for t0, d, name in spans)
                if h[1] > t_start and h[0] < t_end]
        rt_starts = [r[0] for r in self.runtime]
        by = defaultdict(lambda: [0.0, 0, 0.0])
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            inner = [h for h in host if h[0] <= mid < h[1]]
            label = (min(inner, key=lambda h: h[1] - h[0])[2] if inner
                     else "outside the program's spans")
            i = bisect.bisect_right(rt_starts, mid) - 1
            call = self.runtime[i] if i >= 0 else None
            label += (f" / {call[2]}" if call and call[1] > mid
                      else " / host code")
            rec = by[label]
            rec[0] += (b - a) / 1e9
            rec[1] += 1
            rec[2] = max(rec[2], (b - a) / 1e9)
        rows = sorted(by.items(), key=lambda x: -x[1][0])[:top]
        return [[f"{label} ({n} gaps, longest {mx * 1e3:.3f} ms)", s]
                for label, (s, n, mx) in rows]


def _events(prof):
    dev, rt = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((s, end, e.name()))
        elif e.name().startswith(("cuda", "cu")):
            rt.append((s, end, e.name()))
    dev.sort()
    rt.sort()
    return dev, rt


def capture(fn) -> Slice:
    """Profile ``fn()`` (which ends in a device sync)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, rt = _events(prof)
    first = rt[0][0] if rt else (dev[0][0] if dev else 0)
    return Slice(wall_s=wall, host_t0=t0, device=dev, runtime=rt,
                 offset_ns=first - int(t0 * 1e9))


def warm_up() -> None:
    """Start the profiler once, so that a later slice pays no set-up of
    its own."""
    capture(lambda: torch.zeros(1, device="cuda").add_(1))

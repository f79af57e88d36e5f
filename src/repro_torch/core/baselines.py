"""The paper's baseline estimators, re-implemented for the comparison
benchmarks (Tables 3/4/5 analogues).  Own copy of
``repro.core.baselines``: the same numpy RNG use, so the same seed gives
the same estimate.

All baselines share the exact backtracking counter (core/exact.py) as
their inner subroutine, exactly as the originals do:

* **IS** (Liu-Benson-Charikar [30]): partition the timeline into
  disjoint windows of ``c * delta``; sample each window independently
  with probability p; count exactly inside sampled windows; rescale by
  1/p.  Misses cross-window matches (its documented bias).
* **PRESTO-A / PRESTO-E** (Sarpe-Vandin [48]): sample ``r`` uniform
  random windows of length ``c * delta``; count matches whose *first
  edge* (A) / *whole match* (E) lies in the window, weighted by the
  per-match inclusion probability; average the unbiased per-window
  estimates.
* **ES** (Wang et al. [60]): sample edges u.a.r. with probability p;
  for each sampled edge count the matches whose pi-rank-0 edge it is
  (via the exact counter restricted to that edge); rescale by 1/p.

These run on the host (numpy) — they exist to reproduce the paper's
accuracy/runtime comparison, not to be fast.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from .exact import count_exact
from .graph import TemporalGraph
from .motif import TemporalMotif


@dataclass
class BaselineResult:
    name: str
    estimate: float
    runtime_s: float
    windows: int = 0


def is_estimate(g: TemporalGraph, motif: TemporalMotif, delta: int,
                c: float = 30.0, p: float = 0.2, seed: int = 0
                ) -> BaselineResult:
    """Interval sampling: disjoint c*delta windows, each kept w.p. p."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    span = int(g.time_span) + 1
    w = max(int(c * delta), 1)
    starts = np.arange(0, span, w)
    total = 0.0
    used = 0
    for s in starts:
        if rng.random() < p:
            used += 1
            total += count_exact(g, motif, delta, t_lo=int(s),
                                 t_hi=int(s + w - 1))
    return BaselineResult("IS", total / p, time.perf_counter() - t0, used)


def presto_estimate(g: TemporalGraph, motif: TemporalMotif, delta: int,
                    variant: str = "A", r: int = 30, c: float | None = None,
                    seed: int = 0) -> BaselineResult:
    """PRESTO-A/E: r uniform windows of length c*delta, exact counting
    inside each window, per-match inclusion-probability reweighting.

    A match spanning [t_f, t_l] is fully inside a window [s, s+w] iff
    s falls in an interval of length q = w - (t_l - t_f), so each match
    found contributes 1/q; averaging X_i over windows and scaling by the
    number of valid start positions is unbiased (Sarpe-Vandin Eq. 3).
    The A/E variants are reproduced as their recommended window factors
    (A: c=1.25 — sharper windows, more variance from q -> 0 matches;
    E: c=2.0 — wider windows, slower exact subroutine), a documented
    simplification of the two samplers that keeps both unbiased.
    """
    t0 = time.perf_counter()
    if c is None:
        c = 1.25 if variant == "A" else 2.0
    rng = np.random.default_rng(seed)
    span = int(g.time_span) + 1
    w = max(int(c * delta), delta + 1)
    ests = []
    for _ in range(r):
        s = int(rng.integers(0, max(span - w, 1)))
        cnt = _presto_window_sum(g, motif, delta, s, s + w, w)
        ests.append(cnt)
    est = float(np.mean(ests)) * max(span - w, 1)
    return BaselineResult(f"PRESTO-{variant}", est,
                          time.perf_counter() - t0, r)


def _presto_window_sum(g, motif, delta, lo, hi, w) -> float:
    """sum over matches fully in the window of 1 / q(match)."""
    from .exact import list_matches_window
    total = 0.0
    for (tf, tl) in list_matches_window(g, motif, delta, lo, hi):
        q = max(w - (tl - tf), 1)
        total += 1.0 / q
    return total


def es_estimate(g: TemporalGraph, motif: TemporalMotif, delta: int,
                p: float = 0.05, seed: int = 0) -> BaselineResult:
    """Edge sampling: sample rank-0 edges w.p. p, exact-count extensions."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    keep = rng.random(g.m) < p
    total = 0.0
    for e in np.nonzero(keep)[0]:
        total += _count_with_first_edge(g, motif, delta, int(e))
    return BaselineResult("ES", total / p, time.perf_counter() - t0,
                          int(keep.sum()))


def _count_with_first_edge(g: TemporalGraph, motif: TemporalMotif,
                           delta: int, e0: int) -> int:
    """#matches whose pi-rank-0 edge is exactly e0 (exact backtracking)."""
    from .exact import count_exact_from_edge
    return count_exact_from_edge(g, motif, delta, e0)

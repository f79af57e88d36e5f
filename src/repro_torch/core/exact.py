"""Exact temporal motif counting via chronological backtracking (oracle).

Own copy of ``repro.core.exact`` (pure numpy over the host arrays of
``core.graph.TemporalGraph``): the ground truth the port's estimates
are checked against.

This is the BT algorithm of Mackey et al. [31] (the basis of Everest [66]),
re-implemented host-side in numpy/python.  It enumerates *all* M-matches per
Definition 1.2:

* edges mapped in pi (rank) order, timestamps strictly increasing with rank;
* vertex map 1-1;
* all timestamps within ``delta`` of the rank-0 edge.

It is exponential in the worst case and is used only on small graphs as the
ground-truth oracle for the estimator, the baselines and the tests.  It is
also the exact subroutine of the PRESTO/IS-style interval baselines (the
paper's baselines run an exact algorithm on sampled windows).
"""
from __future__ import annotations

import numpy as np

from .graph import TemporalGraph
from .motif import TemporalMotif


def count_exact(g: TemporalGraph, motif: TemporalMotif, delta: int,
                t_lo: int | None = None, t_hi: int | None = None,
                max_matches: int | None = None) -> int:
    """Count M-matches with all edge timestamps in ``[t_lo, t_hi]`` (optional).

    ``t_lo/t_hi`` restrict the *whole match* to a window (used by the
    interval-sampling baselines).  ``max_matches`` aborts early (safety).
    """
    q = motif.num_edges
    nv = motif.num_vertices
    medges = motif.edges

    # graph arrays
    src, dst, t = g.src, g.dst, g.t
    out_ptr, out_edge, out_t = g.out_ptr, g.out_edge, g.out_t
    in_ptr, in_edge, in_t = g.in_ptr, g.in_edge, g.in_t

    lo_bound = 0 if t_lo is None else int(t_lo)
    hi_bound = int(t[-1]) if t_hi is None else int(t_hi)

    # vertex assignment state
    vmap = np.full(nv, -1, dtype=np.int64)     # motif vertex -> graph vertex
    used = {}                                  # graph vertex -> motif vertex
    count = 0

    # Pre-split motif edge endpoints by whether they are bound at each rank.
    # At rank r we match motif edge (x, y); x/y may already be mapped.
    def candidates(r: int, t_prev: int, t_max: int) -> np.ndarray:
        """Graph edge ids matching motif edge r with timestamp in (t_prev, t_max]."""
        x, y = medges[r]
        gx, gy = vmap[x], vmap[y]
        if gx >= 0:
            p0, p1 = out_ptr[gx], out_ptr[gx + 1]
            ts = out_t[p0:p1]
            lo = np.searchsorted(ts, t_prev, side="right")
            hi = np.searchsorted(ts, t_max, side="right")
            es = out_edge[p0 + lo:p0 + hi]
            if gy >= 0:
                es = es[dst[es] == gy]
            else:
                es = es[np.fromiter((dst[e] not in used for e in es),
                                    dtype=bool, count=len(es))]
            return es
        if gy >= 0:
            p0, p1 = in_ptr[gy], in_ptr[gy + 1]
            ts = in_t[p0:p1]
            lo = np.searchsorted(ts, t_prev, side="right")
            hi = np.searchsorted(ts, t_max, side="right")
            es = in_edge[p0 + lo:p0 + hi]
            es = es[np.fromiter((src[e] not in used for e in es),
                                dtype=bool, count=len(es))]
            return es
        raise AssertionError("motif edge with both endpoints unbound at rank>0 "
                             "— motif must be connected")

    def assign(mv: int, gv: int) -> bool:
        if vmap[mv] >= 0:
            return vmap[mv] == gv
        if gv in used:
            return False
        vmap[mv] = gv
        used[gv] = mv
        return True

    def unassign(mv: int, was_unbound: bool) -> None:
        if was_unbound:
            gv = vmap[mv]
            vmap[mv] = -1
            del used[gv]

    def extend(r: int, t0: int, t_prev: int) -> None:
        nonlocal count
        if r == q:
            count += 1
            if max_matches is not None and count >= max_matches:
                raise _Abort()
            return
        t_max = min(t0 + delta, hi_bound)
        for e in candidates(r, t_prev, t_max):
            e = int(e)
            x, y = medges[r]
            ux = vmap[x] < 0
            if not assign(x, int(src[e])):
                continue
            uy = vmap[y] < 0
            if assign(y, int(dst[e])):
                extend(r + 1, t0, int(t[e]))
                unassign(y, uy)
            unassign(x, ux)

    # rank-0 edge: iterate all graph edges in the window
    e0_lo = int(np.searchsorted(t, lo_bound, side="left"))
    e0_hi = int(np.searchsorted(t, hi_bound, side="right"))
    x0, y0 = medges[0]
    try:
        for e0 in range(e0_lo, e0_hi):
            s0, d0 = int(src[e0]), int(dst[e0])
            if s0 == d0:
                continue
            vmap[x0] = s0
            vmap[y0] = d0
            used.clear()
            used[s0] = x0
            used[d0] = y0
            extend(1, int(t[e0]), int(t[e0]))
            vmap[x0] = -1
            vmap[y0] = -1
            used.clear()
    except _Abort:
        pass
    return count


class _Abort(Exception):
    pass


def count_exact_from_edge(g: TemporalGraph, motif: TemporalMotif,
                          delta: int, e0: int) -> int:
    """#matches whose pi-rank-0 edge is exactly ``e0`` (ES subroutine)."""
    src, dst, t = g.src, g.dst, g.t
    s0, d0 = int(src[e0]), int(dst[e0])
    if s0 == d0:
        return 0
    sub = _Backtracker(g, motif, delta, 0, int(t[-1]))
    return sub.count_from(e0)


def list_matches_window(g: TemporalGraph, motif: TemporalMotif, delta: int,
                        t_lo: int, t_hi: int) -> list[tuple[int, int]]:
    """(t_first, t_last) of every match fully inside [t_lo, t_hi].

    The PRESTO subroutine: per-match spans drive the inclusion-probability
    reweighting.  Same backtracking as count_exact, collecting spans.
    """
    spans: list[tuple[int, int]] = []
    sub = _Backtracker(g, motif, delta, t_lo, t_hi, spans=spans)
    sub.count_all()
    return spans


class _Backtracker:
    """Shared chronological-backtracking engine (count_exact variants)."""

    def __init__(self, g, motif, delta, t_lo, t_hi, spans=None):
        self.g, self.motif, self.delta = g, motif, delta
        self.t_lo, self.t_hi = t_lo, t_hi
        self.spans = spans
        self.count = 0

    def count_all(self) -> int:
        g, t = self.g, self.g.t
        import numpy as np
        e_lo = int(np.searchsorted(t, self.t_lo, side="left"))
        e_hi = int(np.searchsorted(t, self.t_hi, side="right"))
        for e0 in range(e_lo, e_hi):
            self.count_from(e0)
        return self.count

    def count_from(self, e0: int) -> int:
        import numpy as np
        g, motif = self.g, self.motif
        src, dst, t = g.src, g.dst, g.t
        q = motif.num_edges
        medges = motif.edges
        vmap: dict[int, int] = {}
        used: dict[int, int] = {}
        before = self.count
        x0, y0 = medges[0]
        s0, d0 = int(src[e0]), int(dst[e0])
        if s0 == d0:
            return 0
        vmap[x0] = s0
        vmap[y0] = d0
        used[s0] = x0
        used[d0] = y0
        t0 = int(t[e0])

        def cands(r, t_prev, t_max):
            x, y = medges[r]
            gx = vmap.get(x, -1)
            gy = vmap.get(y, -1)
            if gx >= 0:
                p0, p1 = g.out_ptr[gx], g.out_ptr[gx + 1]
                ts = g.out_t[p0:p1]
                lo = np.searchsorted(ts, t_prev, side="right")
                hi = np.searchsorted(ts, t_max, side="right")
                es = g.out_edge[p0 + lo:p0 + hi]
                if gy >= 0:
                    return es[dst[es] == gy]
                return es[np.fromiter((int(dst[e]) not in used for e in es),
                                      dtype=bool, count=len(es))]
            p0, p1 = g.in_ptr[gy], g.in_ptr[gy + 1]
            ts = g.in_t[p0:p1]
            lo = np.searchsorted(ts, t_prev, side="right")
            hi = np.searchsorted(ts, t_max, side="right")
            es = g.in_edge[p0 + lo:p0 + hi]
            return es[np.fromiter((int(src[e]) not in used for e in es),
                                  dtype=bool, count=len(es))]

        def extend(r, t_prev):
            if r == q:
                self.count += 1
                if self.spans is not None:
                    self.spans.append((t0, t_prev))
                return
            t_max = min(t0 + self.delta, self.t_hi)
            for e in cands(r, t_prev, t_max):
                e = int(e)
                x, y = medges[r]
                ux = x not in vmap
                uy = y not in vmap
                gs, gd = int(src[e]), int(dst[e])
                if vmap.get(x, gs) != gs or (ux and gs in used):
                    continue
                vmap[x] = gs
                used[gs] = x
                if vmap.get(y, gd) != gd or (uy and gd in used):
                    if ux:
                        del vmap[x], used[gs]
                    continue
                vmap[y] = gd
                used[gd] = y
                extend(r + 1, int(t[e]))
                if uy:
                    del vmap[y], used[gd]
                if ux:
                    del vmap[x], used[gs]

        extend(1, t0)
        return self.count - before


def list_exact(g: TemporalGraph, motif: TemporalMotif, delta: int,
               limit: int = 1_000_000) -> list[tuple[int, ...]]:
    """Enumerate matches as tuples of graph edge ids (rank order).

    Brute force over rank-ordered edge combinations — obviously correct,
    *tiny graphs only* (test helper; O(m^q)).
    """
    import itertools

    q = motif.num_edges
    medges = motif.edges
    src, dst, t = g.src, g.dst, g.t
    out: list[tuple[int, ...]] = []
    # Edges are globally sorted by (t, src, dst); combinations() preserves id
    # order, which on ties (equal t) can differ from time order, so re-check.
    for combo in itertools.combinations(range(g.m), q):
        ts = [int(t[e]) for e in combo]
        if any(ts[i] >= ts[i + 1] for i in range(q - 1)):
            continue
        if ts[-1] - ts[0] > delta:
            continue
        vmap: dict[int, int] = {}
        rmap: dict[int, int] = {}
        ok = True
        for (mx, my), e in zip(medges, combo):
            for mv, gv in ((mx, int(src[e])), (my, int(dst[e]))):
                if vmap.get(mv, gv) != gv or rmap.get(gv, mv) != mv:
                    ok = False
                    break
                vmap[mv] = gv
                rmap[gv] = mv
            if not ok:
                break
        if ok:
            out.append(combo)
            if len(out) >= limit:
                break
    return out

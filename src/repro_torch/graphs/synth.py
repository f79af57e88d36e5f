"""Reproducible synthetic temporal multigraphs.

The port's own copy of ``repro.graphs.synth``: the same seed gives the
same arrays.

The paper evaluates on wiki-talk / stackoverflow / bitcoin / reddit-reply,
which cannot be redistributed in this offline container.  These generators
produce graphs with the *properties that matter to TIMEST*:

* heavy-tailed degree distribution (skewed candidate-list lengths),
* temporal multi-edges between the same ordered pair (multiplicity sigma,
  the quantity that makes temporal counting explode combinatorially),
* bursty timestamps (matches within small windows are common),
* a long overall time span (many 2*delta subgraphs).

All generators are deterministic in ``seed`` and return edge arrays that
``TemporalGraph.from_edges`` dedupes into the unique-(u,v,t) input model.
"""
from __future__ import annotations

import numpy as np

from ..core.graph import TemporalGraph


def _finish(src, dst, t, rng, jitter_span) -> TemporalGraph:
    """Drop self loops, jitter duplicate (u,v,t) tuples, build the graph."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    keep = src != dst
    src, dst, t = src[keep], dst[keep], t[keep]
    if len(src) == 0:
        raise ValueError("generator produced an empty graph")
    # de-duplicate (u,v,t) collisions by re-jittering (keeps edge count stable)
    for _ in range(8):
        key = (src * (dst.max() + 1) + dst) * np.int64(jitter_span + 1) + t
        _, first = np.unique(key, return_index=True)
        dup = np.ones(len(src), dtype=bool)
        dup[first] = False
        if not dup.any():
            break
        t = t.copy()
        t[dup] = t[dup] + rng.integers(1, 5, size=int(dup.sum()))
    return TemporalGraph.from_edges(src, dst, t)


def powerlaw_temporal_graph(n: int = 500, m: int = 5000, alpha: float = 1.8,
                            time_span: int = 100_000, burstiness: float = 0.6,
                            multiplicity: float = 0.15,
                            seed: int = 0) -> TemporalGraph:
    """Chung-Lu style temporal graph with bursty repeats.

    ``multiplicity`` is the fraction of edges that re-use an existing (u, v)
    pair with a nearby timestamp (creating temporal multi-edges, the regime
    where sigma_delta > 1 and DeriveCnt's ListCount DP matters).
    """
    rng = np.random.default_rng(seed)
    w = (np.arange(1, n + 1, dtype=np.float64)) ** (-1.0 / (alpha - 1.0))
    p = w / w.sum()
    base = int(m * (1 - multiplicity))
    src = rng.choice(n, size=base, p=p)
    dst = rng.choice(n, size=base, p=p)
    # bursty timestamps: mixture of uniform and clustered-around-hotspots
    n_hot = max(4, time_span // 5000)
    hot = rng.integers(0, time_span, size=n_hot)
    is_burst = rng.random(base) < burstiness
    t_uniform = rng.integers(0, time_span, size=base)
    t_burst = (hot[rng.integers(0, n_hot, size=base)]
               + rng.normal(0, time_span * 0.01, size=base).astype(np.int64))
    t = np.where(is_burst, t_burst, t_uniform)
    t = np.clip(t, 0, time_span)

    # multiplicity edges: repeat existing pairs at nearby times
    n_rep = m - base
    if n_rep > 0:
        pick = rng.integers(0, base, size=n_rep)
        src = np.concatenate([src, src[pick]])
        dst = np.concatenate([dst, dst[pick]])
        dt = rng.geometric(0.002, size=n_rep)
        t = np.concatenate([t, np.clip(t[pick] + dt, 0, time_span)])
    return _finish(src, dst, t, rng, time_span + 16)


def er_temporal_graph(n: int = 200, m: int = 2000, time_span: int = 50_000,
                      seed: int = 0) -> TemporalGraph:
    """Uniform (Erdos-Renyi-ish) temporal graph — the unskewed control."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    t = rng.integers(0, time_span, size=m)
    return _finish(src, dst, t, rng, time_span + 16)


def fintxn_temporal_graph(n_accounts: int = 400, m: int = 6000,
                          time_span: int = 200_000, n_rings: int = 12,
                          ring_size: int = 5, n_smurf: int = 8,
                          seed: int = 0) -> TemporalGraph:
    """Financial-transaction-like graph with planted laundering structures.

    Background: power-law transfers.  Planted: (a) temporal simple cycles
    ("round-tripping", Fig 1b/1c), (b) scatter-gather fan-out/fan-in bursts
    (Fig 1d), (c) bipartite layering (Fig 1e).  Used by the fraud example and
    by tests that need guaranteed nonzero counts for the Figure-1 motifs.
    """
    rng = np.random.default_rng(seed)
    g_bg = powerlaw_temporal_graph(n=n_accounts, m=m, time_span=time_span,
                                   seed=seed + 1)
    src = [g_bg.src.astype(np.int64)]
    dst = [g_bg.dst.astype(np.int64)]
    t = [g_bg.t.astype(np.int64)]

    def plant(edges_uv: list[tuple[int, int]], start: int, gap: int) -> None:
        tt = start
        for (u, v) in edges_uv:
            src.append(np.array([u]))
            dst.append(np.array([v]))
            t.append(np.array([tt]))
            tt += max(1, int(rng.integers(1, gap)))

    for _ in range(n_rings):  # temporal cycles
        ring = rng.choice(n_accounts, size=ring_size, replace=False)
        edges = [(int(ring[i]), int(ring[(i + 1) % ring_size]))
                 for i in range(ring_size)]
        plant(edges, int(rng.integers(0, time_span)), gap=50)

    for _ in range(n_smurf):  # scatter-gather: hub -> mules -> collector
        vs = rng.choice(n_accounts, size=5, replace=False)
        hub, a, b, c, coll = map(int, vs)
        plant([(hub, a), (hub, b), (hub, c), (a, coll), (b, coll), (c, coll)],
              int(rng.integers(0, time_span)), gap=40)

    for _ in range(n_smurf // 2):  # bipartite layering 2x3
        vs = rng.choice(n_accounts, size=5, replace=False)
        s0, s1, d0, d1, d2 = map(int, vs)
        plant([(s0, d0), (s0, d1), (s0, d2), (s1, d0), (s1, d1), (s1, d2)],
              int(rng.integers(0, time_span)), gap=40)

    return _finish(np.concatenate(src), np.concatenate(dst),
                   np.concatenate(t), rng, time_span + 2048)

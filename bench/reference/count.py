"""Validation and DeriveCnt of sampled trees (paper Alg. 4/5).

A sample is valid when its motif vertices map to distinct graph
vertices, its tree edges span at most ``delta`` and their times follow
the motif's order.  Its count is the number of ways to complete it with
the motif's non-tree edges, each drawn from the time-sorted list of
graph edges of its vertex pair, in order and within ``delta``: a DP over
the lists, each cut to ``Lmax`` entries with the overflow flagged, and,
when the first and the last motif edges are both non-tree, a loop over
the first list's entries that keeps the last within ``delta`` of it.  A
count is doubled where one window holds the match (``N_phi = 1``), so
every sum stays an integer.  Each list bound is one ``searchsorted`` on
the pair-CSR's composite keys.
"""
from __future__ import annotations

import torch

ACC_KEYS = ("cnt2", "valid", "fail_vmap", "fail_delta", "fail_order",
            "overflow")
INF = torch.iinfo(torch.int64).max // 4


def vertex_map(g, tree, edges):
    """``[K, nv]``: the graph vertex of every motif vertex."""
    return torch.stack([(g["src"] if end == 0 else g["dst"])[edges[:, s]]
                        .long() for s, end in tree.vertex_source], dim=1)


def counts(g, k, tree, w, edges, Lmax: int = 16) -> dict:
    """Per-sample flags and ``cnt2`` of the samples ``edges [K, S]``."""
    medges = tree.motif_edges
    S, nq = tree.S, len(medges)
    rank_order = sorted(range(S), key=lambda s: tree.edges[s])
    tree_ranks = sorted(tree.edges)
    nt_ranks = [r for r in range(nq) if r not in set(tree.edges)]
    local = {tree.edges[s]: s for s in range(S)}
    coupled = bool(nt_ranks) and nt_ranks[0] == 0 and nt_ranks[-1] == nq - 1

    t = g["t"]
    dev = t.device
    delta, wd = w.delta, w.wd
    phi_v = vertex_map(g, tree, edges)
    ts = t[edges]
    sv = torch.sort(phi_v, dim=1).values
    ok_vmap = (sv[:, 1:] != sv[:, :-1]).all(dim=1)
    tmin, tmax = ts.min(dim=1).values, ts.max(dim=1).values
    ok_delta = (tmax - tmin) <= delta
    tr = ts[:, rank_order]
    ok_order = (tr[:, 1:] > tr[:, :-1]).all(dim=1)
    valid = ok_vmap & ok_delta & ok_order
    i_hi = torch.clamp(tmin // wd, max=w.q - 1)
    i_lo = torch.clamp(tmax // wd - 1, min=0)
    nphi = torch.clamp(i_hi - i_lo + 1, 1, 2)

    K = edges.shape[0]
    overflow = torch.zeros(K, dtype=torch.bool, device=dev)
    if not nt_ranks:
        cnt = torch.ones(K, dtype=torch.int64, device=dev)
    else:
        n = int(g["n"])
        pk, span, pt = g["pair_key"], k["span"], g["pair_t"]
        t_first = ts[:, local[tree_ranks[0]]]
        t_last = ts[:, local[tree_ranks[-1]]]
        iota = torch.arange(Lmax, dtype=torch.int64, device=dev)
        lists, lens = [], []
        for r in nt_ranks:
            x, y = medges[r]
            key = phi_v[:, x] * n + phi_v[:, y]
            pid = torch.searchsorted(pk, key).clamp(max=pk.numel() - 1)
            exists = pk[pid] == key
            base = pid * span

            def bound(x, right):
                return torch.searchsorted(k["pair"],
                                          base + x.clamp(0, span - 1),
                                          right=right)

            lo = bound(t_last - delta, False)
            hi = bound(t_first + delta, True)
            below = [q for q in tree_ranks if q < r]
            above = [q for q in tree_ranks if q > r]
            if below:                          # strictly after that pin
                lo = torch.maximum(lo, bound(ts[:, local[below[-1]]], True))
            if above:                          # strictly before that pin
                hi = torch.minimum(hi, bound(ts[:, local[above[0]]], False))
            ln = torch.where(exists, (hi - lo).clamp(min=0), 0)
            overflow = overflow | (ln > Lmax)
            ln = ln.clamp(max=Lmax)
            pos = (lo[:, None] + iota[None, :]).clamp(0, pt.numel() - 1)
            lists.append(torch.where(iota[None, :] < ln[:, None], pt[pos],
                                     INF))
            lens.append(ln)

        def chain(f, start):
            for j in range(start, len(lists)):
                less = lists[j - 1][:, :, None] < lists[j][:, None, :]
                f = (f[:, :, None] * less).sum(dim=1)
                f = torch.where(lists[j] < INF, f, 0)
            return f

        if len(lists) == 1 and not coupled:
            cnt = lens[0]
        elif not coupled:
            cnt = chain((lists[0] < INF).long(), 1).sum(dim=1)
        else:
            cnt = torch.zeros(K, dtype=torch.int64, device=dev)
            for jj in range(Lmax):
                tj = lists[0][:, jj]
                ok = tj < INF
                if len(lists) == 1:
                    cnt = cnt + ok.long()
                    continue
                f = torch.zeros((K, Lmax), dtype=torch.int64, device=dev)
                f[:, jj] = 1
                f = chain(torch.where(ok[:, None], f, 0), 1)
                cnt = cnt + (f * (lists[-1] <= tj[:, None] + delta)).sum(1)
    cnt = torch.where(valid & ~overflow, cnt, 0)
    return dict(cnt2=torch.where(nphi == 1, 2 * cnt, cnt), valid=valid,
                fail_vmap=~ok_vmap, fail_delta=ok_vmap & ~ok_delta,
                fail_order=ok_vmap & ok_delta & ~ok_order, overflow=overflow)


def chunk_sums(c: dict) -> dict:
    """The six int64 sums of a chunk."""
    return {kk: int(c[kk].sum(dtype=torch.int64)) for kk in ACC_KEYS}

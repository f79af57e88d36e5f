"""A communication network: Chung-Lu power-law degrees, bursty times,
repeated pairs, every vertex on some edge.

The degree law of the port's ``graphs.synth.powerlaw_temporal_graph``
(which this does not import): vertex ``i`` (from 1) has weight
``i^(-1/(alpha-1))`` and an endpoint is drawn in proportion to it.
Exactly ``pairs`` distinct directed pairs, no self-loop: the first
``vertices`` candidates join each vertex in turn (in an order drawn from
the seed, as source or destination at even odds) to a drawn endpoint, so
that every vertex has an edge; the rest join two drawn endpoints.  Each
pair has a first edge, whose timestamp is for a share ``burstiness``
near a hot spot (one per ``hotspot_every_s`` seconds of the span, normal
spread ``hotspot_sigma_share`` of the span) and otherwise uniform; the
other ``edges - pairs`` edges each repeat a pair drawn uniformly, a
geometric gap (``repeat_gap_p``) after its first edge.  Drawn with one
``torch.Generator`` on the device in a few large calls; repeated
``(u, v, t)`` tuples are dropped and the draws carry enough margin that
exactly ``edges`` remain.
"""
from __future__ import annotations

import math

import torch


def endpoints(n: int, alpha: float, size: int, gen, device):
    """``size`` vertex ids drawn in proportion to ``i^(-1/(alpha-1))``."""
    w = torch.arange(1, n + 1, dtype=torch.float64, device=device) ** (
        -1.0 / (alpha - 1.0))
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(size, dtype=torch.float64, generator=gen, device=device)
    return torch.searchsorted(cdf, u, right=True).clamp(max=n - 1)


def geometric(p: float, size: int, gen, device):
    """Draws of a geometric law on ``1, 2, ...`` of success rate ``p``."""
    u = torch.rand(size, dtype=torch.float64, generator=gen, device=device)
    u = u.clamp(min=1e-300)
    return (torch.floor(torch.log(u) / math.log1p(-p)) + 1).long()


def repeats(src, dst, t, share_of: int, p: float, span: int, gen):
    """Edges that repeat a pair of ``(src, dst, t)`` a geometric gap
    later."""
    pick = torch.randint(0, src.numel(), (share_of,), generator=gen,
                         device=src.device)
    dt = geometric(p, share_of, gen, src.device)
    return src[pick], dst[pick], (t[pick] + dt).clamp(0, span)


def first_unique(parts, quotas):
    """Concatenate ``parts`` (each ``(src, dst, t)``), drop self-loops
    and every ``(u, v, t)`` seen earlier in the concatenation, and keep
    the first ``quotas[i]`` survivors of part ``i`` (``None``: all)."""
    src = torch.cat([p[0] for p in parts])
    dst = torch.cat([p[1] for p in parts])
    t = torch.cat([p[2] for p in parts])
    o = torch.argsort(t, stable=True)
    o = o[torch.argsort(dst[o], stable=True)]
    o = o[torch.argsort(src[o], stable=True)]
    dup_sorted = torch.zeros(o.numel(), dtype=torch.bool, device=src.device)
    s, d, tt = src[o], dst[o], t[o]
    dup_sorted[1:] = ((s[1:] == s[:-1]) & (d[1:] == d[:-1])
                      & (tt[1:] == tt[:-1]))
    dup = torch.empty_like(dup_sorted)
    dup[o] = dup_sorted
    ok = (src != dst) & ~dup
    keep, at = [], 0
    for p, quota in zip(parts, quotas):
        n = p[0].numel()
        idx = at + torch.nonzero(ok[at:at + n]).flatten()
        if quota is not None:
            if idx.numel() < quota:
                raise RuntimeError(f"generator margin too small: "
                                   f"{idx.numel()} of {quota} edges "
                                   "survived")
            idx = idx[:quota]
        keep.append(idx)
        at += n
    keep = torch.cat(keep)
    return src[keep], dst[keep], t[keep]


def covering_pairs(n: int, alpha: float, size: int, gen, device):
    """``size`` candidate pairs ``(src, dst)``: the first ``n`` join
    vertex ``perm[i]`` to a drawn endpoint (never itself), the rest two
    drawn endpoints."""
    own = torch.randperm(n, generator=gen, device=device)
    other = endpoints(n, alpha, n, gen, device)
    other = torch.where(other == own, (own + 1) % n, other)
    flip = torch.rand(n, generator=gen, device=device) < 0.5
    src = torch.cat([torch.where(flip, other, own),
                     endpoints(n, alpha, size - n, gen, device)])
    dst = torch.cat([torch.where(flip, own, other),
                     endpoints(n, alpha, size - n, gen, device)])
    return src, dst


def generate(cfg: dict, seed: int, device):
    """``(src, dst, t)`` int64 on ``device``: exactly ``cfg["edges"]``
    over exactly ``cfg["pairs"]`` directed pairs touching all
    ``cfg["vertices"]``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n, m, span = cfg["vertices"], cfg["edges"], cfg["time_span_s"]
    n_pairs = cfg["pairs"]
    if not n <= n_pairs <= m:
        raise ValueError("need vertices <= pairs <= edges")
    src, dst = covering_pairs(n, cfg["alpha"], int(n_pairs * 1.3) + 1000,
                              gen, device)
    src, dst, _ = first_unique([(src, dst, torch.zeros_like(src))],
                               [n_pairs])
    n_hot = max(4, span // cfg["hotspot_every_s"])
    hot = torch.randint(0, span, (n_hot,), generator=gen, device=device)
    burst = torch.rand(n_pairs, generator=gen,
                       device=device) < cfg["burstiness"]
    t_uni = torch.randint(0, span, (n_pairs,), generator=gen, device=device)
    jitter = torch.normal(0.0, span * cfg["hotspot_sigma_share"],
                          (n_pairs,), generator=gen, device=device)
    t_hot = hot[torch.randint(0, n_hot, (n_pairs,), generator=gen,
                              device=device)] + jitter.round().long()
    t = torch.where(burst, t_hot, t_uni).clamp(0, span)
    n_rep = m - n_pairs
    rep = repeats(src, dst, t, int(n_rep * 1.05) + 1000,
                  cfg["repeat_gap_p"], span, gen)
    return first_unique([(src, dst, t), rep], [n_pairs, n_rep])

"""Sampling weights of a rooted tree (paper Alg. 1/2, Claims 4.8-4.10).

The graph is cut into overlapping windows ``[i*wd, (i+2)*wd)``; every
edge lies in its own window ``floor(t/wd)`` and the one before, so each
tree edge keeps two weights per graph edge, ``own`` and ``prev``: the
number of matches of its subtree that hang off that edge inside that
window.  A dependency's sum over the meet vertex's CSR segment (times
within ``delta`` on the side ``beta`` says, and inside the window) is
two differences of the child's exclusive prefix sums, split at the
window's midpoint; the Claim 4.8 exclusion subtracts the same sum over
the edges parallel to the parent.  Each bound is one ``searchsorted``
on the composite keys of ``graph.keys``.

``dtype=torch.int64`` is the exact computation.  ``torch.float32`` runs
the same arithmetic in float32, as the TPU kernels' weights do below
2^24: the lower precision the benchmark's control uses.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .motifs import BEFORE, OUT


@dataclass
class RefWeights:
    delta: int
    wd: int
    q: int
    ps_acc_own: list       # per tree edge, exclusive prefixes [m+1] in the
    ps_acc_prev: list      # order the parent reads the edge through
    ps_pair_own: list      # ... and in pair-CSR order (None for the root)
    ps_pair_prev: list
    ps_win: torch.Tensor   # [q+1] exclusive prefix of window totals
    win_lo: torch.Tensor   # [q] first edge of window i, of its second
    win_mid: torch.Tensor  # half, and past its end
    win_hi: torch.Tensor
    W: int


def num_windows(time_span: int, wd: int) -> int:
    """``q``: the windows ``[i*wd, (i+2)*wd)``, ``i < q``, hold every
    match."""
    return max(1, -(-int(time_span + 1) // int(wd)) - 1)


def _excl(x):
    return torch.cat([x.new_zeros(1), torch.cumsum(x, 0)])


def _bounds(key, owner, span, lo_t, hi_t, mid_t):
    """Positions of the time bounds ``[lo_t, hi_t]`` and ``mid_t`` inside
    each owner's segment of a composite key: (lower bound of lo_t, upper
    bound of hi_t, lower bound of mid_t clamped between them)."""
    base = owner * span
    plo = torch.searchsorted(key, base + lo_t.clamp(0, span - 1))
    phi = torch.searchsorted(key, base + hi_t.clamp(0, span - 1), right=True)
    pmid = torch.searchsorted(key, base + mid_t.clamp(0, span - 1))
    pmid = torch.minimum(torch.maximum(pmid, plo), phi)
    return plo, phi, pmid


def pair_of(g, meet_end: int, alpha: int):
    """Each edge's Claim 4.8 list: the pair between the meet vertex and
    the edge's other end, in the direction ``alpha`` reads."""
    if alpha == OUT:
        return g["pair_id"] if meet_end == 0 else g["rev_pair_id"]
    return g["rev_pair_id"] if meet_end == 0 else g["pair_id"]


def time_range(t, win, delta, wd, beta):
    """The times a child may take around parent time ``t`` in window
    ``win``: ``delta`` before or after, clipped to the window."""
    if beta == BEFORE:
        return torch.maximum(t - delta, win * wd), t
    return t, torch.minimum(t + delta, (win + 2) * wd - 1)


def dep_sum(g, k, meet_end, alpha, beta, window, delta, wd, ps, ps_pair):
    """One dependency's sum for every graph edge as the parent, in the
    ``own`` or ``prev`` window of the parent, less the edges parallel to
    the parent."""
    t = g["t"]
    meet = (g["src"] if meet_end == 0 else g["dst"]).long()
    win = t // wd if window == "own" else t // wd - 1
    tlo, thi = time_range(t, win, delta, wd, beta)
    brk = (win + 1) * wd
    key = k["out"] if alpha == OUT else k["inn"]
    plo, phi, pmid = _bounds(key, meet, k["span"], tlo, thi, brk)
    out = (ps[0][pmid] - ps[0][plo]) + (ps[1][phi] - ps[1][pmid])
    pid = pair_of(g, meet_end, alpha).long()
    qlo, qhi, qmid = _bounds(k["pair"], pid.clamp(min=0), k["span"], tlo,
                             thi, brk)
    el = (ps_pair[0][qmid] - ps_pair[0][qlo]) + (ps_pair[1][qhi]
                                                 - ps_pair[1][qmid])
    return out - torch.where(pid >= 0, el, torch.zeros_like(el))


def weights(g, k, tree, delta: int, dtype=torch.int64) -> RefWeights:
    """The tree's weights and prefix sums for window ``delta``."""
    t = g["t"]
    m = t.numel()
    wd = int(delta)
    q = num_windows(int(t[-1]), wd)
    fl = t // wd
    own_ok, prev_ok = fl <= q - 1, fl >= 1
    S = tree.S
    alpha_of = [0] * S
    for s in range(S):
        for (c, _, alpha, _) in tree.deps[s]:
            alpha_of[c] = alpha
    w_own, w_prev = [None] * S, [None] * S
    acc, pair = {}, {}
    for s in reversed(tree.topo_down):           # children first
        wo = torch.ones(m, dtype=dtype, device=t.device)
        wp = torch.ones(m, dtype=dtype, device=t.device)
        for (c, meet_end, alpha, beta) in tree.deps[s]:
            args = (meet_end, alpha, beta)
            wo = wo * dep_sum(g, k, *args, "own", delta, wd, acc[c], pair[c])
            wp = wp * dep_sum(g, k, *args, "prev", delta, wd, acc[c], pair[c])
        w_own[s] = torch.where(own_ok, wo, torch.zeros_like(wo))
        w_prev[s] = torch.where(prev_ok, wp, torch.zeros_like(wp))
        if s == tree.root:
            acc[s] = (_excl(w_own[s]), _excl(w_prev[s]))
        else:
            perm = (g["out_edge"] if alpha_of[s] == OUT
                    else g["in_edge"]).long()
            pe = g["pair_edge"].long()
            acc[s] = (_excl(w_own[s][perm]), _excl(w_prev[s][perm]))
            pair[s] = (_excl(w_own[s][pe]), _excl(w_prev[s][pe]))
    ro, rp = acc[tree.root]
    i = torch.arange(q, dtype=torch.int64, device=t.device)
    lo = torch.searchsorted(t, i * wd)
    mid = torch.searchsorted(t, (i + 1) * wd)
    hi = torch.searchsorted(t, (i + 2) * wd)
    ps_win = _excl((ro[mid] - ro[lo]) + (rp[hi] - rp[mid]))
    as64 = (lambda x: x) if dtype == torch.int64 else (
        lambda x: None if x is None else x.round().to(torch.int64))
    return RefWeights(
        delta=int(delta), wd=wd, q=q,
        ps_acc_own=[as64(acc[s][0]) for s in range(S)],
        ps_acc_prev=[as64(acc[s][1]) for s in range(S)],
        ps_pair_own=[as64(pair[s][0]) if s in pair else None
                     for s in range(S)],
        ps_pair_prev=[as64(pair[s][1]) if s in pair else None
                      for s in range(S)],
        ps_win=as64(ps_win), win_lo=lo, win_mid=mid, win_hi=hi,
        W=int(as64(ps_win)[-1]))

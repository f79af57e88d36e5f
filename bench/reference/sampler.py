"""Spanning-tree sampling (paper Alg. 3) of one chunk from its key.

Per sample: a window ``i`` with probability ``W_i / W``; the center
edge by the inverse CDF of the root's weights inside the window (its
own-window half, then its prev-window half); then every child, parents
first, by the inverse CDF of the child's weights over the meet vertex's
CSR segment within the time range, less the edges parallel to the
parent (Claim 4.8).  The draws are jax's: ``keys = split(key, S + 2)``,
the window target ``randint(keys[0], K, W)``, and for child ``c`` the
two raw 64-bit draws that ``randint(keys[2 + c], ...)`` reduces against
the child's own total.

Each inverse CDF is a ``searchsorted`` of a global prefix array.  With
the exclusion, the target is raised by the excluded weight that lies
before the candidate until the candidate stops moving (at most one step
per excluded edge in range), which gives the least position whose
cumulative weight net of exclusions exceeds the draw.
"""
from __future__ import annotations

import torch

from . import rng
from .motifs import OUT
from .weights import _bounds, time_range


def draws(tree, W: int, key, K: int):
    """``(x [K], uhi [K, S], ulo [K, S])`` for the chunk key ``key``."""
    keys = rng.split(key, tree.S + 2)
    x = rng.randint(keys[0], K, max(int(W), 1))
    d = rng.bits(rng.split(keys[2:], 2), K)          # [S, 2, K]
    return x, d[:, 0].T, d[:, 1].T


def _inverse_two_piece(pso, psp, lo, mid, hi, r):
    """Least ``p`` in ``[lo, hi)`` with ``C(p + 1) > r``, where ``C(p)``
    sums own-window weights over ``[lo, min(p, mid))`` and prev-window
    ones over ``[mid, max(p, mid))``; ``r < C(hi)`` puts it in range, and
    the clamp only keeps rounded weights (the control) inside."""
    c_mid = pso[mid] - pso[lo]
    first = torch.searchsorted(pso, pso[lo] + r, right=True) - 1
    second = torch.searchsorted(psp, psp[mid] + (r - c_mid), right=True) - 1
    p = torch.where(r < c_mid, first, second)
    return torch.minimum(torch.maximum(p, lo), torch.maximum(hi - 1, lo))


def _two_piece(pso, psp, lo, mid, p):
    return ((pso[torch.minimum(p, mid)] - pso[lo])
            + (psp[torch.maximum(p, mid)] - psp[mid]))


def sample(g, k, tree, w, key, K: int, exact: bool = True):
    """``(edges [K, S], window [K])``: chunk ``key``'s K samples.

    Weights rounded from float32 (``exact=False``, the control) need not
    net out their exclusions exactly, so the cumulative weight may dip
    and the search may not settle: it then stops after its bound."""
    t = g["t"]
    src, dst = g["src"].long(), g["dst"].long()
    x, uhi, ulo = draws(tree, w.W, key, K)
    win = (torch.searchsorted(w.ps_win, x, right=True) - 1).clamp(0, w.q - 1)
    resid = x - w.ps_win[win]
    edges = [None] * tree.S
    r = tree.root
    edges[r] = _inverse_two_piece(w.ps_acc_own[r], w.ps_acc_prev[r],
                                  w.win_lo[win], w.win_mid[win],
                                  w.win_hi[win], resid)
    span = k["span"]
    for (s, c, meet_end, alpha, beta, use_rev) in tree.schedule():
        e = edges[s]
        meet = (src if meet_end == 0 else dst)[e]
        tlo, thi = time_range(t[e], win, w.delta, w.wd, beta)
        brk = (win + 1) * w.wd
        if alpha == OUT:
            key_csr, csr_edge, key_pos = k["out"], g["out_edge"], k["pos_out"]
        else:
            key_csr, csr_edge, key_pos = k["inn"], g["in_edge"], k["pos_in"]
        plo, phi, pmid = _bounds(key_csr, meet, span, tlo, thi, brk)
        pso, psp = w.ps_acc_own[c], w.ps_acc_prev[c]
        pid = (g["rev_pair_id"] if use_rev else g["pair_id"])[e].long()
        has = pid >= 0
        pid0 = pid.clamp(min=0)
        qlo, qhi, qmid = _bounds(k["pair"], pid0, span, tlo, thi, brk)
        qhi = torch.where(has, qhi, qlo)
        qmid = torch.where(has, qmid, qlo)
        ppo, ppp = w.ps_pair_own[c], w.ps_pair_prev[c]
        m1 = t.numel() + 1

        def excluded(p):
            # weight of the parallel edges at CSR positions < p
            cross = torch.searchsorted(key_pos, pid0 * m1 + p)
            cross = torch.minimum(torch.maximum(cross, qlo), qhi)
            return _two_piece(ppo, ppp, qlo, qmid, cross)

        total = _two_piece(pso, psp, plo, pmid, phi) - excluded(phi)
        rx = rng.randint_from_bits(uhi[:, c], ulo[:, c], total.clamp(min=1))
        p = _inverse_two_piece(pso, psp, plo, pmid, phi, rx)
        for _ in range(int((qhi - qlo).max()) + 1):
            nxt = _inverse_two_piece(pso, psp, plo, pmid, phi,
                                     rx + excluded(p + 1))
            if torch.equal(nxt, p):
                break
            p = nxt
        else:
            if exact:
                raise RuntimeError("reference sampler: inverse CDF did not "
                                   "settle")
        edges[c] = csr_edge[p.clamp(max=t.numel() - 1)].long()
    return torch.stack(edges, dim=1), win

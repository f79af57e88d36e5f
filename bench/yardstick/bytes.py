"""Bytes the TIMEST kernels' functions must move on given inputs.

Frozen from the port's smoke run and rewritten in plain torch on the
reference's index (``bench.reference``).  They count what the function
needs on these inputs, not what one kernel design moves: a kernel that
reads less than this is impossible, one that reads more pays for its
own design.

``sampler_bytes``: the tree sampler (Alg. 3) on one chunk.  The key
once and the outputs once (the kernel draws its own bits), plus one
8-byte word per gather a bisection makes on each sample's data: the
window search over ``q``; the center edge's inverse CDF over its
window's edge range; per child the three bounds in the meet vertex's
CSR segment and in its parallel-edge list (full segment lengths), then
the inverse CDF over the time range ``[plo, phi)`` only, each step two
prefix words plus, with the Claim 4.8 exclusion, the nested search over
``[qlo, qhi)`` and two more prefix words.

``dep_sum_bytes``: one dep-sum of the weight DP: each array the function
needs read once and its output written once.
"""
from __future__ import annotations

import torch

from ..reference.motifs import BEFORE, OUT
from ..reference.weights import _bounds, pair_of


def bisect_steps(n):
    """Trips of a bisection over ``n`` elements: ``ceil(log2(n + 1))``."""
    return torch.ceil(torch.log2(n.double() + 1)).long()


def find_steps(n):
    """Trips of an inverse-CDF search over ``n`` positions:
    ``ceil(log2(n))``, at least 0."""
    return torch.ceil(torch.log2(n.clamp(min=1).double())).long()


def sampler_bytes(g, k, tree, w, edges, window) -> int:
    """Bytes the tree sampler must move to draw ``edges [K, S]`` and
    ``window [K]`` (one stream of one launch)."""
    K = window.shape[0]
    t = g["t"]
    win = window
    words = bisect_steps(torch.full_like(win, w.q)) + 4
    words = words + 2 + 2 * find_steps(w.win_hi[win] - w.win_lo[win])
    span = k["span"]
    for (s, c, meet_end, alpha, beta, use_rev) in tree.schedule():
        e = edges[:, s]
        meet = (g["src"] if meet_end == 0 else g["dst"])[e].long()
        te = t[e]
        ptr, key = ((g["out_ptr"], k["out"]) if alpha == OUT
                    else (g["in_ptr"], k["inn"]))
        p0, p1 = ptr[meet], ptr[meet + 1]
        if beta == BEFORE:
            tlo, thi = torch.maximum(te - w.delta, win * w.wd), te
        else:
            tlo, thi = te, torch.minimum(te + w.delta, (win + 2) * w.wd - 1)
        plo, phi, _ = _bounds(key, meet, span, tlo, thi, thi)
        evals = find_steps(phi - plo) + 1
        words = words + 5 + 3 * bisect_steps(p1 - p0) + 2 + 2 * evals
        pid = (g["rev_pair_id"] if use_rev else g["pair_id"])[e].long()
        pid0 = pid.clamp(min=0)
        q0 = g["pair_ptr"][pid0]
        q1 = torch.where(pid >= 0, g["pair_ptr"][pid0 + 1], q0)
        qlo, qhi, _ = _bounds(k["pair"], pid0, span, tlo, thi, thi)
        qlo = torch.where(pid >= 0, qlo, q0)
        qhi = torch.where(pid >= 0, qhi, q0)
        words = (words + 3 + 3 * bisect_steps(q1 - q0) + 2
                 + evals * (bisect_steps(qhi - qlo) + 2))
    return int(words.sum()) * 8 + 16 + K * 8 * (tree.S + 1)


def dep_sum_bytes(g, meet_end: int, alpha: int, use_c2: bool) -> int:
    """Bytes one dep-sum must move: each edge's time and meet vertex,
    the alpha-CSR's pointers and times, the child's two prefixes; with
    C2 each edge's pair id, the pair pointers and times and two more
    prefixes; the output once."""
    a = "out" if alpha == OUT else "in"
    need = [g["t"], g["src" if meet_end == 0 else "dst"], g[f"{a}_ptr"],
            g[f"{a}_t"]]
    if use_c2:
        need += [pair_of(g, meet_end, alpha), g["pair_ptr"], g["pair_t"]]
    m = g["t"].numel()
    prefixes = (4 if use_c2 else 2) * (m + 1) * 8
    return sum(x.numel() * x.element_size() for x in need) + prefixes + m * 8

"""Plain torch versions of the interval-weight sums and the dep-sum.

``interval_weight_ref`` answers explicit queries; ``dep_sum_ref`` is one
whole Claim 4.9 dep-sum of the weight DP: the queries of every edge
(``dep_sum_queries``), the Lambda sum over the meet vertex's CSR segment,
minus (with C2) the Claim 4.8 sum over the edge's parallel-edge list.
``ops.dep_sum`` runs ``dep_sum_ref`` on CPU tensors, and ``chip_smoke.py``
holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch

from ...core.bisect import bisect_iters, seg_lower_bound, seg_upper_bound
from ...core.spanning_tree import BEFORE, OUT, Dependency


def interval_weight_ref(csr_t, ps_own, ps_prev, p0, p1, tlo, thi, brk):
    """``(ps_own[pmid] - ps_own[plo]) + (ps_prev[phi] - ps_prev[pmid])``
    with ``plo/phi/pmid`` the bisections of ``[tlo, thi]`` and ``brk``
    inside the CSR segment ``[p0, p1)`` of ``csr_t``."""
    it = bisect_iters(csr_t.shape[0])
    plo = seg_lower_bound(csr_t, p0, p1, tlo, iters=it)
    phi = seg_upper_bound(csr_t, p0, p1, thi, iters=it)
    pmid = torch.minimum(torch.maximum(
        seg_lower_bound(csr_t, p0, p1, brk, iters=it), plo), phi)
    return (ps_own[pmid] - ps_own[plo]) + (ps_prev[phi] - ps_prev[pmid])


def pair_ids(dev: dict, d: Dependency) -> torch.Tensor:
    """Each edge's parallel-edge list for ``d``'s Claim 4.8 exclusion: the
    pair of the meet vertex and the edge's *other* endpoint, in the
    direction ``alpha`` reads (``[m]`` int32, -1 where there is none)."""
    if d.alpha == OUT:
        return dev["pair_id"] if d.meet_end == 0 else dev["rev_pair_id"]
    return dev["rev_pair_id"] if d.meet_end == 0 else dev["pair_id"]


def dep_sum_queries(dev: dict, d: Dependency, delta: int, wd: int,
                    window: str, use_c2: bool) -> dict:
    """The interval-weight queries of one dependency's dep-sum, all edges.

    ``window`` is ``"own"`` (window ``i = floor(t/wd)``) or ``"prev"``
    (``i - 1``).  Returns ``lam = (csr_t, p0, p1, tlo, thi, brk)`` for
    the Lambda sum over the alpha-CSR segment of the meet vertex and,
    with ``use_c2``, ``el = (pair_t, q0, q1, tlo, thi, brk)`` for the
    parallel-edge exclusion (Claim 4.8).  The caller pairs each with the
    child's prefix sums in the same order.
    """
    t = dev["t"]
    meet = (dev["src"] if d.meet_end == 0 else dev["dst"]).long()
    if d.alpha == OUT:
        ptr, csr_t = dev["out_ptr"], dev["out_t"]
    else:
        ptr, csr_t = dev["in_ptr"], dev["in_t"]
    p0 = ptr[meet]
    p1 = ptr[meet + 1]
    i = t // wd if window == "own" else t // wd - 1
    if d.beta == BEFORE:
        tlo = torch.maximum(t - delta, i * wd)
        thi = t
    else:
        tlo = t
        thi = torch.minimum(t + delta, (i + 2) * wd - 1)
    brk = (i + 1) * wd
    out = dict(lam=(csr_t, p0, p1, tlo, thi, brk))
    if use_c2:
        pid = pair_ids(dev, d).long()
        pid0 = pid.clamp(min=0)
        q0 = dev["pair_ptr"][pid0]
        q1 = torch.where(pid >= 0, dev["pair_ptr"][pid0 + 1], q0)
        out["el"] = (dev["pair_t"], q0, q1, tlo, thi, brk)
    return out


def dep_sum_ref(dev: dict, d: Dependency, window: str, delta: int, wd: int,
                ps_csr: tuple, ps_pair: tuple | None) -> torch.Tensor:
    """Claim 4.9's dep-sum of every edge: Lambda, minus the Claim 4.8
    exclusion when ``ps_pair`` is given (C2 on).

    ``ps_csr = (own, prev)`` are the child's exclusive prefixes ``[m+1]``
    in its alpha-CSR order, ``ps_pair`` the same in pair-CSR order.
    """
    qs = dep_sum_queries(dev, d, delta, wd, window, ps_pair is not None)
    csr_t, *lam_q = qs["lam"]
    lam = interval_weight_ref(csr_t, *ps_csr, *lam_q)
    if ps_pair is None:
        return lam
    pair_t, *el_q = qs["el"]
    return lam - interval_weight_ref(pair_t, *ps_pair, *el_q)

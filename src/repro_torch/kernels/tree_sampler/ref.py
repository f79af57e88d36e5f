"""Plain torch version of the tree-sampler kernel, on precomputed draws.

The same exact-int64 arithmetic as the JAX reference sampler
(``repro.core.sampler._make_sample_fn_xla``) but consuming the kernel's
randomness inputs ``(x, uhi, ulo)`` instead of a key.  Used on CPU
tensors by ``ops.tree_sampler`` and held against the CUDA kernel on the
card by ``chip_smoke.py``.
"""
from __future__ import annotations

import torch

from ...core.bisect import (bisect_iters, monotone_find, seg_lower_bound,
                            seg_upper_bound)
from ...core.rng import randint_from_bits
from ...core.spanning_tree import BEFORE, OUT


def _two_piece(ps_own, ps_prev, lo, mid):
    """Cumulative-in-window weight ``C(p)`` built from the own/prev split.

    ``C(p) = (PSo[min(p,mid)] - PSo[lo]) + (PSp[max(p,mid)] - PSp[mid])``;
    positions < mid are in their own window, >= mid in their prev window.
    Gathers are clamped to the array, as jnp gathers clamp.
    """
    nmax = ps_own.shape[0] - 1
    base_own = ps_own[lo.clamp(0, nmax)]
    base_prev = ps_prev[mid.clamp(0, nmax)]

    def C(p):
        return ((ps_own[torch.minimum(p, mid).clamp(0, nmax)] - base_own)
                + (ps_prev[torch.maximum(p, mid).clamp(0, nmax)]
                   - base_prev))
    return C


def tree_sampler_ref(schedule, root: int, S: int, dev: dict, wts, x, uhi,
                     ulo):
    """Alg. 3 for ``K = len(x)`` samples; returns ``(edges [K, S], window
    [K])`` int64.

    ``schedule`` is ``ops.build_schedule(tree)``; ``uhi/ulo [K, S]`` hold
    the two raw 64-bit draws of each child's ``randint`` (int64 bit
    patterns; the root's column is unused).
    """
    t = dev["t"]
    m = t.shape[0]
    it = bisect_iters(m)
    delta, wd, q = wts.delta, wts.wd, wts.q
    K = x.shape[0]
    # trip count from the window-array length, as the reference's: the
    # search runs over the real [0, q) (pad windows have W_i = 0)
    itq = bisect_iters(wts.q_pad)

    # -- 1. window -------------------------------------------------------
    zeros = torch.zeros(K, dtype=torch.int64, device=x.device)
    win = seg_upper_bound(wts.ps_win, zeros, torch.full_like(zeros, q), x,
                          iters=itq) - 1
    win = win.clamp(0, q - 1)
    resid = x - wts.ps_win[win]

    # -- 2. center edge --------------------------------------------------
    lo, mid, hi = wts.win_lo[win], wts.win_mid[win], wts.win_hi[win]
    Cc = _two_piece(wts.ps_acc_own[root], wts.ps_acc_prev[root], lo, mid)
    edges = [None] * S
    edges[root] = monotone_find(Cc, lo, hi, resid, iters=it)

    # -- 3. children, top-down (static schedule) ---------------------------
    src, dst = dev["src"].long(), dev["dst"].long()
    for (s, c, meet_end, alpha, beta, use_rev) in schedule:
        e = edges[s]
        meet = (src if meet_end == 0 else dst)[e]
        te = t[e]
        if alpha == OUT:
            ptr, csr_t = dev["out_ptr"], dev["out_t"]
            csr_edge, pair_pos = dev["out_edge"], dev["pair_pos_out"]
        else:
            ptr, csr_t = dev["in_ptr"], dev["in_t"]
            csr_edge, pair_pos = dev["in_edge"], dev["pair_pos_in"]
        p0 = ptr[meet]
        p1 = ptr[meet + 1]
        if beta == BEFORE:
            tlo = torch.maximum(te - delta, win * wd)
            thi = te
        else:
            tlo = te
            thi = torch.minimum(te + delta, (win + 2) * wd - 1)
        brk = (win + 1) * wd
        plo = seg_lower_bound(csr_t, p0, p1, tlo, iters=it)
        phi = seg_upper_bound(csr_t, p0, p1, thi, iters=it)
        pmid = torch.minimum(torch.maximum(
            seg_lower_bound(csr_t, p0, p1, brk, iters=it), plo), phi)
        CL = _two_piece(wts.ps_acc_own[c], wts.ps_acc_prev[c], plo, pmid)

        if wts.use_c2:
            pid = (dev["rev_pair_id"] if use_rev else dev["pair_id"])[e]
            pid = pid.long()
            pid0 = pid.clamp(min=0)
            pair_ptr = dev["pair_ptr"]
            q0 = pair_ptr[pid0]
            q1 = torch.where(pid >= 0, pair_ptr[pid0 + 1], q0)
            pt = dev["pair_t"]
            qlo = seg_lower_bound(pt, q0, q1, tlo, iters=it)
            qhi = seg_upper_bound(pt, q0, q1, thi, iters=it)
            qmid = torch.minimum(torch.maximum(
                seg_lower_bound(pt, q0, q1, brk, iters=it), qlo), qhi)
            CE = _two_piece(wts.ps_pair_own[c], wts.ps_pair_prev[c], qlo,
                           qmid)

            def g(p, CL=CL, CE=CE, pair_pos=pair_pos, qlo=qlo, qhi=qhi):
                cross = seg_lower_bound(pair_pos, qlo, qhi, p, iters=it)
                return CL(p) - CE(cross)
        else:
            g = CL

        span = g(phi).clamp(min=1)
        rx = randint_from_bits(uhi[:, c], ulo[:, c], span)
        pstar = monotone_find(g, plo, phi, rx, iters=it)
        edges[c] = csr_edge[pstar.clamp(0, m - 1)].long()

    return torch.stack(edges, dim=1), win

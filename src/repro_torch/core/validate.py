"""Validate sampled trees + DeriveCnt (paper Alg. 4/5), vectorized over K.

Torch counterpart of ``repro.core.validate`` (its docstring holds the
design notes): plain torch ops on the device of the samples, as the JAX
package runs this step in XLA with no Pallas kernel.

Validation (Alg. 4) checks the constraints the sampler relaxed: a 1-1
vertex map, all tree-edge timestamps within ``delta``, and timestamps
strictly following the motif's pi order; ``N_phi`` (windows containing
the match) is the Constraint-3 multiplicity correction.  DeriveCnt
(Alg. 5) counts the extensions of a valid tree over the non-tree edges
with a linear DP over their time-bounded pair lists, padded to ``Lmax``
with overflow reported, never truncated silently; when both extreme
ranks are non-tree edges a guarded outer loop over the first list
enforces ``t_last <= t_first + delta``.
"""
from __future__ import annotations

import torch

from .bisect import bisect_iters, seg_lower_bound, seg_upper_bound
from .spanning_tree import SpanningTree

INF = torch.iinfo(torch.int64).max // 4


def make_count_fn(tree: SpanningTree, K: int, Lmax: int = 16):
    """``fn(dev, wts, samples) -> dict`` of per-sample counts and flags."""
    motif = tree.motif
    S = tree.num_edges
    nq = motif.num_edges

    # ---- static schedule -------------------------------------------------
    rank_order = sorted(range(S), key=lambda s: tree.edge_ids[s])
    tree_ranks = sorted(tree.edge_ids)
    nt_ranks = [r for r in range(nq) if r not in set(tree.edge_ids)]
    local_of_rank = {tree.edge_ids[s]: s for s in range(S)}
    min_pin_local = local_of_rank[tree_ranks[0]]
    max_pin_local = local_of_rank[tree_ranks[-1]]
    coupled = bool(nt_ranks) and (nt_ranks[0] == 0 and nt_ranks[-1] == nq - 1)

    def pin_below(r):  # tree-local index of nearest pin with smaller rank
        c = [x for x in tree_ranks if x < r]
        return local_of_rank[c[-1]] if c else None

    def pin_above(r):
        c = [x for x in tree_ranks if x > r]
        return local_of_rank[c[0]] if c else None

    def fn(dev, wts, samples):
        t = dev["t"]
        it = bisect_iters(t.shape[0])
        E = samples["edges"]          # [K, S]
        phi_v = samples["phi_v"]      # [K, nv]
        delta, wd = wts.delta, wts.wd
        ts = t[E]                     # [K, S]

        # ---- Alg. 4 validation ------------------------------------------
        sv = torch.sort(phi_v, dim=1).values
        ok_vmap = (sv[:, 1:] != sv[:, :-1]).all(dim=1)
        tmin = ts.min(dim=1).values
        tmax = ts.max(dim=1).values
        ok_delta = (tmax - tmin) <= delta
        ts_ranked = ts[:, rank_order]
        ok_order = (ts_ranked[:, 1:] > ts_ranked[:, :-1]).all(dim=1)
        valid = ok_vmap & ok_delta & ok_order

        # N_phi: #windows [i*wd,(i+2)*wd) containing all tree timestamps
        i_hi = torch.clamp(tmin // wd, max=wts.q - 1)
        i_lo = torch.clamp(tmax // wd - 1, min=0)
        nphi = torch.clamp(i_hi - i_lo + 1, 1, 2)

        # ---- Alg. 5 DeriveCnt ----------------------------------------------
        Kn = E.shape[0]
        overflow = torch.zeros(Kn, dtype=torch.bool, device=t.device)
        if not nt_ranks:
            cnt = torch.ones(Kn, dtype=torch.int64, device=t.device)
        else:
            n = dev["n"]
            pk = dev["pair_key"]
            P = pk.shape[0]
            pt = dev["pair_t"]
            t_min_pin = ts[:, min_pin_local]
            t_max_pin = ts[:, max_pin_local]
            iota = torch.arange(Lmax, dtype=torch.int64, device=t.device)

            t_lists = []
            len_lists = []
            for r in nt_ranks:
                x, y = motif.edges[r]
                key = phi_v[:, x] * n + phi_v[:, y]
                pp = torch.searchsorted(pk, key)
                ppc = pp.clamp(max=P - 1)
                exists = pk[ppc] == key
                a = dev["pair_ptr"][ppc]
                b = torch.where(exists, dev["pair_ptr"][ppc + 1], a)
                # closed global bounds
                lo_pos = seg_lower_bound(pt, a, b, t_max_pin - delta,
                                         iters=it)
                hi_pos = seg_upper_bound(pt, a, b, t_min_pin + delta,
                                         iters=it)
                lb = pin_below(r)
                if lb is not None:  # strict > pin
                    lo_pos = torch.maximum(
                        lo_pos, seg_upper_bound(pt, a, b, ts[:, lb],
                                                iters=it))
                ub = pin_above(r)
                if ub is not None:  # strict < pin
                    hi_pos = torch.minimum(
                        hi_pos, seg_lower_bound(pt, a, b, ts[:, ub],
                                                iters=it))
                ln = (hi_pos - lo_pos).clamp(min=0)
                overflow = overflow | (ln > Lmax)
                ln = ln.clamp(max=Lmax)
                pos = lo_pos[:, None] + iota[None, :]
                tk = torch.where(iota[None, :] < ln[:, None],
                                 pt[pos.clamp(0, pt.shape[0] - 1)], INF)
                t_lists.append(tk)        # [K, Lmax], INF-padded
                len_lists.append(ln)

            def chain(f, start_k):
                """Run DP transitions from layer start_k-1 to the end."""
                for k in range(start_k, len(t_lists)):
                    less = t_lists[k - 1][:, :, None] < t_lists[k][:, None, :]
                    f = (f[:, :, None] * less).sum(dim=1)
                    f = torch.where(t_lists[k] < INF, f, 0)
                return f

            if len(t_lists) == 1 and not coupled:
                cnt = len_lists[0]
            elif not coupled:
                f0 = (t_lists[0] < INF).long()
                cnt = chain(f0, 1).sum(dim=1)
            else:
                # guarded outer loop over the first list (delta coupling)
                cnt = torch.zeros(Kn, dtype=torch.int64, device=t.device)
                for jj in range(Lmax):
                    tj = t_lists[0][:, jj]
                    ok_j = tj < INF
                    if len(t_lists) == 1:
                        # single list that is both first and last rank
                        cnt = cnt + ok_j.long()
                        continue
                    f = torch.zeros((Kn, Lmax), dtype=torch.int64,
                                    device=t.device)
                    f[:, jj] = 1
                    f = torch.where(ok_j[:, None], f, 0)
                    f = chain(f, 1)
                    last_ok = t_lists[-1] <= (tj[:, None] + delta)
                    cnt = cnt + (f * last_ok).sum(dim=1)

        cnt = torch.where(valid & ~overflow, cnt, 0)
        # Constraint-3 correction: divide by N_phi, kept exact via 2x scaling
        cnt2 = torch.where(nphi == 1, 2 * cnt, cnt)
        return dict(cnt=cnt, cnt2=cnt2, nphi=nphi, valid=valid,
                    ok_vmap=ok_vmap,
                    fail_vmap=~ok_vmap,
                    fail_delta=ok_vmap & ~ok_delta,
                    fail_order=ok_vmap & ok_delta & ~ok_order,
                    overflow=overflow)

    return fn

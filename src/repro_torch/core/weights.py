"""Preprocess sampling weights (paper Alg. 1/2, Claims 4.9/4.10).

Torch counterpart of ``repro.core.weights`` (its docstring holds the
design notes).  The graph is cut into ``q`` overlapping ``2*wd``
windows ``[i*wd, (i+2)*wd)``; every edge lies in exactly two of them
(``own = floor(t/wd)`` and ``prev = own - 1``), so each tree edge ``s``
keeps two dense weight arrays ``w_own[s]``/``w_prev[s]`` and every
interval sum inside a window splits at the ``(i+1)*wd`` breakpoint into
four gathers of exclusive prefix sums held in CSR order.

Each dep-sum (Claim 4.9, less the Claim 4.8 exclusion) is one call of
the dep-sum op (``kernels/interval_weight``): one launch of the CUDA
kernel on the card, its plain twin on the CPU (``dep_sum_queries``, then
two interval-weight sums).  All weight arithmetic is exact int64.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.interval_weight.ops import dep_sum, kernel_arrays
from .graph import TemporalGraph, pad_bucket
from .spanning_tree import OUT, SpanningTree


@dataclass
class Weights:
    """Per-tree-edge weight arrays + the prefix sums the sampler needs.

    ``ps_acc_*[s]`` is the exclusive prefix over ``w_*[s]`` permuted into
    the order the *parent* dependency accesses edge ``s`` through: the
    root uses global (time-sorted) edge order, a child with ``alpha=OUT``
    the out-CSR order, ``alpha=IN`` the in-CSR order.  ``ps_pair_*[s]`` is
    the prefix over pair-CSR order (the ``\\ El`` exclusion of Claim 4.8).
    """

    tree: SpanningTree
    delta: int
    wd: int                    # window stride (== delta; C3-off: span + 1)
    q: int                     # real window count (<= q_pad)
    use_c2: bool
    w_own: torch.Tensor        # [S, m] int64
    w_prev: torch.Tensor       # [S, m] int64
    ps_acc_own: torch.Tensor   # [S, m+1]
    ps_acc_prev: torch.Tensor  # [S, m+1]
    ps_pair_own: torch.Tensor  # [S, m+1]
    ps_pair_prev: torch.Tensor  # [S, m+1]
    W_total: torch.Tensor      # 0-d int64
    ps_win: torch.Tensor       # [q_pad+1] exclusive prefix of window totals
    win_lo: torch.Tensor       # [q_pad] first edge id with t >= i*wd
    win_mid: torch.Tensor      # [q_pad] first edge id with t >= (i+1)*wd
    win_hi: torch.Tensor       # [q_pad] first edge id with t >= (i+2)*wd

    @property
    def W_win(self) -> torch.Tensor:
        return self.ps_win[1:] - self.ps_win[:-1]

    @property
    def q_pad(self) -> int:
        """Window-array length (>= q; == q on unpadded graphs)."""
        return int(self.ps_win.shape[0]) - 1

    @property
    def nbytes(self) -> int:
        """Bytes held by the arrays (``ARRAY_FIELDS``)."""
        arrays = (getattr(self, k) for k in ARRAY_FIELDS)
        return sum(x.nelement() * x.element_size() for x in arrays)

    def to(self, device) -> "Weights":
        """An exact copy on ``device`` (the arrays are int64)."""
        return dataclasses.replace(self, **{
            k: getattr(self, k).to(device) for k in ARRAY_FIELDS})


ARRAY_FIELDS = ("w_own", "w_prev", "ps_acc_own", "ps_acc_prev",
                "ps_pair_own", "ps_pair_prev", "W_total", "ps_win",
                "win_lo", "win_mid", "win_hi")


def weights_from_numpy(tree: SpanningTree, delta: int, wd: int, q: int,
                       use_c2: bool, arrays: dict, device) -> Weights:
    """``Weights`` on ``device`` from numpy arrays of the same names
    (``ARRAY_FIELDS``), e.g. the JAX reference's preprocess output."""
    return Weights(tree=tree, delta=int(delta), wd=int(wd), q=int(q),
                   use_c2=bool(use_c2),
                   **{k: torch.as_tensor(np.asarray(arrays[k]).astype(
                       np.int64)).to(device) for k in ARRAY_FIELDS})


def access_alpha(tree: SpanningTree) -> list[int]:
    """Direction (OUT/IN/0) through which each tree edge is accessed.

    ``alpha_of[root] = 0`` (accessed via the global time order); every
    other tree edge is accessed through its single parent-dependency
    direction.
    """
    alpha = [0] * tree.num_edges
    for s in range(tree.num_edges):
        for d in tree.deps[s]:
            alpha[d.child] = d.alpha
    return alpha


def _excl(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum with a leading zero: [m] -> [m+1]."""
    return torch.cat([x.new_zeros(1), torch.cumsum(x, 0)])


def num_windows(time_span: int, wd: int) -> int:
    """q such that windows [i*wd, (i+2)*wd), i in [0, q) cover every match."""
    return max(1, -(-int(time_span + 1) // int(wd)) - 1)


def make_preprocess_fn(tree: SpanningTree, use_c2: bool = True):
    """Build ``fn(dev, delta, wd, q, q_pad=None) -> weight dict``.

    ``wd`` is the window stride (Constraint 3): ``wd == delta`` normally,
    ``wd > time_span`` collapses to a single window (C3 disabled).
    ``use_c2=False`` drops the ``\\ El`` exclusion (Constraint 2
    disabled).  The window arrays get ``q_pad`` entries (``q`` when not
    given).  The arrays live on the device of ``dev``.
    """
    S = tree.num_edges
    order = list(reversed(tree.topo_down))   # children before parents
    alpha_of = access_alpha(tree)
    root = tree.root

    def fn(dev, delta, wd, q, q_pad=None):
        delta, wd, q = int(delta), int(wd), int(q)
        t = dev["t"]
        m = t.shape[0]
        fl = t // wd
        real = torch.arange(m, device=t.device) < dev["m_real"]
        own_ok = (fl <= q - 1) & real
        prev_ok = (fl >= 1) & real

        w_own: list = [None] * S
        w_prev: list = [None] * S
        w_csr: dict = {}
        w_pair: dict = {}
        arrays: dict = {}   # the dep-sum's gathered inputs, per kind
        for s in order:
            wo = torch.ones(m, dtype=torch.int64, device=t.device)
            wp = torch.ones(m, dtype=torch.int64, device=t.device)
            for d in tree.deps[s]:
                ps_csr = w_csr[d.child]
                ps_pair = w_pair[d.child] if use_c2 else None
                kind = (d.meet_end, d.alpha)
                if kind not in arrays:
                    arrays[kind] = kernel_arrays(dev, d)
                args = (delta, wd, ps_csr, ps_pair, arrays[kind])
                wo = wo * dep_sum(dev, d, "own", *args)
                wp = wp * dep_sum(dev, d, "prev", *args)
            wo = torch.where(own_ok, wo, 0)
            wp = torch.where(prev_ok, wp, 0)
            w_own[s], w_prev[s] = wo, wp
            # prefix sums in the order this edge is *accessed* through
            if s != root:
                perm = (dev["out_edge"] if alpha_of[s] == OUT
                        else dev["in_edge"]).long()
                pe = dev["pair_edge"].long()
                w_csr[s] = (_excl(wo[perm]), _excl(wp[perm]))
                w_pair[s] = (_excl(wo[pe]), _excl(wp[pe]))

        zeros = torch.zeros(m + 1, dtype=torch.int64, device=t.device)
        ps_root = (_excl(w_own[root]), _excl(w_prev[root]))
        acc = [ps_root if s == root else w_csr[s] for s in range(S)]
        pair = [(zeros, zeros) if s == root else w_pair[s] for s in range(S)]
        out = dict(
            w_own=torch.stack(w_own), w_prev=torch.stack(w_prev),
            ps_acc_own=torch.stack([a[0] for a in acc]),
            ps_acc_prev=torch.stack([a[1] for a in acc]),
            ps_pair_own=torch.stack([p[0] for p in pair]),
            ps_pair_prev=torch.stack([p[1] for p in pair]))
        out.update(window_totals(t, ps_root[0], ps_root[1], wd, q,
                                 q if q_pad is None else int(q_pad)))
        out["W_total"] = out["ps_win"][-1]
        return out

    return fn


def window_totals(t, ps_root_own, ps_root_prev, wd: int, q: int,
                  q_pad: int) -> dict:
    """Per-window totals (Claim 4.10 restricted to window i) over
    ``q_pad >= q`` window slots: slots ``>= q`` get ``W_i = 0``, so
    ``ps_win`` is flat across them and the window draw never lands
    there."""
    iarr = torch.arange(q_pad, dtype=torch.int64, device=t.device)
    win_lo = torch.searchsorted(t, iarr * wd, side="left")
    win_mid = torch.searchsorted(t, (iarr + 1) * wd, side="left")
    win_hi = torch.searchsorted(t, (iarr + 2) * wd, side="left")
    W_i = ((ps_root_own[win_mid] - ps_root_own[win_lo])
           + (ps_root_prev[win_hi] - ps_root_prev[win_mid]))
    W_i = torch.where(iarr < q, W_i, 0)
    return dict(ps_win=_excl(W_i), win_lo=win_lo, win_mid=win_mid,
                win_hi=win_hi)


def preprocess(g: TemporalGraph, tree: SpanningTree, delta: int,
               dev: dict | None = None, use_c2: bool = True,
               use_c3: bool = True, device: str = "cuda") -> Weights:
    """Alg. 1: weights + prefix structure for the whole graph.

    ``dev`` (from ``g.device_arrays``) is built on ``device`` when not
    given; otherwise the arrays land where ``dev`` lives.
    """
    if dev is None:
        dev = g.device_arrays(device)
    wd = int(delta) if use_c3 else int(g.time_span) + 1
    q = num_windows(g.time_span, wd)
    # a padded snapshot buckets its window arrays too, as the reference's
    q_pad = pad_bucket(q) if g.pad_windows else q
    out = make_preprocess_fn(tree, use_c2=use_c2)(dev, delta, wd, q, q_pad)
    return Weights(tree=tree, delta=int(delta), wd=wd, q=q, use_c2=use_c2,
                   **out)

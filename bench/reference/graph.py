"""The temporal graph's index, built from its edge list with sorts.

Plain torch on whatever device the edges are on.  The arrays and dtypes
are those a TIMEST estimator reads (Sec. 4): vertices relabelled to
``0 .. n-1`` in id order, edges numbered in ``(t, src, dst)`` order
with ``t`` shifted to start at 0, an out-, an in- and a pair-CSR (each
segment in edge order, so time-sorted), every pair's reversed pair, and
each pair slot's position inside the out- and in-CSR.  ``keys`` adds
the composite sort keys ``owner * span + t`` that let one
``searchsorted`` find a time bound inside any CSR segment.
"""
from __future__ import annotations

import torch

I32, I64 = torch.int32, torch.int64


def _excl_counts(group, size):
    ptr = torch.zeros(size + 1, dtype=I64, device=group.device)
    ptr[1:] = torch.cumsum(torch.bincount(group, minlength=size), 0)
    return ptr


def build_index(src, dst, t) -> dict:
    """The index of the edges ``(src, dst, t)`` (int64 tensors).

    Repeated ``(u, v, t)`` tuples are kept once; self-loops are refused.
    """
    src, dst, t = src.long(), dst.long(), t.long()
    if bool((src == dst).any()):
        raise ValueError("self-loops are not part of the input model")
    m0 = src.numel()
    verts, inv = torch.unique(torch.cat([src, dst]), return_inverse=True)
    n = verts.numel()
    s, d = inv[:m0], inv[m0:]
    t = t - t.min()
    o = torch.argsort(d, stable=True)
    o = o[torch.argsort(s[o], stable=True)]
    o = o[torch.argsort(t[o], stable=True)]
    s, d, t = s[o], d[o], t[o]
    keep = torch.ones_like(s, dtype=torch.bool)
    keep[1:] = ~((s[1:] == s[:-1]) & (d[1:] == d[:-1]) & (t[1:] == t[:-1]))
    s, d, t = s[keep], d[keep], t[keep]
    m = s.numel()
    ar = torch.arange(m, dtype=I64, device=s.device)

    out_edge = torch.argsort(s, stable=True)
    in_edge = torch.argsort(d, stable=True)
    pkey = s * n + d
    uniq, pair_id = torch.unique(pkey, return_inverse=True)
    P = uniq.numel()
    pair_edge = torch.argsort(pair_id, stable=True)
    rkey = d * n + s
    ridx = torch.searchsorted(uniq, rkey).clamp(max=P - 1)
    rev_pair_id = torch.where(uniq[ridx] == rkey, ridx, -1)
    out_pos = torch.empty_like(ar)
    out_pos[out_edge] = ar
    in_pos = torch.empty_like(ar)
    in_pos[in_edge] = ar
    return dict(
        src=s.to(I32), dst=d.to(I32), t=t,
        out_ptr=_excl_counts(s, n), out_edge=out_edge.to(I32),
        out_t=t[out_edge],
        in_ptr=_excl_counts(d, n), in_edge=in_edge.to(I32),
        in_t=t[in_edge],
        n=torch.tensor(n, dtype=I64, device=s.device),
        pair_key=uniq, pair_ptr=_excl_counts(pair_id, P),
        pair_edge=pair_edge.to(I32), pair_t=t[pair_edge],
        pair_id=pair_id.to(I32), rev_pair_id=rev_pair_id.to(I32),
        pair_pos_out=out_pos[pair_edge], pair_pos_in=in_pos[pair_edge],
        m_real=torch.tensor(m, dtype=I64, device=s.device))


def keys(g: dict) -> dict:
    """Composite sort keys of every CSR: ``owner * span + time`` (span =
    time span + 2, so every clamped time bound stays in its owner's
    range), and ``pair * (m + 1) + position`` for the pair slots'
    positions in the out- and in-CSR."""
    span = int(g["t"][-1]) + 2
    m = g["t"].numel()

    def owners(ptr):
        return torch.repeat_interleave(
            torch.arange(ptr.numel() - 1, device=ptr.device), ptr.diff())

    pair_owner = owners(g["pair_ptr"])
    return dict(span=span,
                out=owners(g["out_ptr"]) * span + g["out_t"],
                inn=owners(g["in_ptr"]) * span + g["in_t"],
                pair=pair_owner * span + g["pair_t"],
                pos_out=pair_owner * (m + 1) + g["pair_pos_out"],
                pos_in=pair_owner * (m + 1) + g["pair_pos_in"])


def arrays_differing(got: dict, want: dict) -> list:
    """Names of the index arrays whose dtype, shape or values differ."""
    bad = []
    for name, w in want.items():
        g = got.get(name)
        if (g is None or g.dtype != w.dtype or g.shape != w.shape
                or not torch.equal(g.to(w.device), w)):
            bad.append(name)
    return bad

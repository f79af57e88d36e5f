"""Branchless fixed-trip binary searches over sorted segments (vectorized).

Torch counterpart of ``repro.core.bisect``: every search walks the same
``(l, h)`` trajectory as the JAX reference, over any batch shape of
queries, with clamped gathers so empty segments (``lo == hi``) are safe.
The CUDA kernels carry the same loop body in ``kernels/csrc/bisect.cuh``.

Trip counts (the callers pass them):

* ``bisect_iters(m) = max(8, m.bit_length() + 1)`` covers any segment
  of an ``m``-edge graph (sampler, validation, interval-weight op);
* the window search uses ``bisect_iters(q)`` for ``q`` windows.

Extra iterations are converged no-ops, so the result is the exact
lower/upper bound whenever the trip count covers the segment.
"""
from __future__ import annotations

import torch


def bisect_iters(m: int) -> int:
    """Trip count that covers any segment of an ``m``-element array."""
    return max(8, int(m).bit_length() + 1)


def _search(vals: torch.Tensor, lo, hi, target, iters: int,
            upper: bool) -> torch.Tensor:
    nmax = vals.shape[0] - 1
    l, h = torch.broadcast_tensors(torch.as_tensor(lo, device=vals.device),
                                   torch.as_tensor(hi, device=vals.device))
    l, h = l.clone(), h.clone()
    for _ in range(iters):
        mid = (l + h) >> 1
        v = vals[mid.clamp(0, nmax)]
        active = l < h
        go_right = active & ((v <= target) if upper else (v < target))
        l = torch.where(go_right, mid + 1, l)
        h = torch.where(active & ~go_right, mid, h)
    return l


def seg_lower_bound(vals: torch.Tensor, lo, hi, target,
                    iters: int) -> torch.Tensor:
    """Smallest ``p in [lo, hi]`` with ``vals[p] >= target`` (``hi`` if none).

    ``vals`` must be non-decreasing inside every queried ``[lo, hi)``.
    """
    return _search(vals, lo, hi, target, iters, upper=False)


def seg_upper_bound(vals: torch.Tensor, lo, hi, target,
                    iters: int) -> torch.Tensor:
    """Smallest ``p in [lo, hi]`` with ``vals[p] > target`` (``hi`` if none)."""
    return _search(vals, lo, hi, target, iters, upper=True)


def monotone_find(g, lo, hi, r, iters: int) -> torch.Tensor:
    """Generalized inverse CDF: smallest ``p in [lo, hi)`` with ``g(p+1) > r``.

    ``g`` is a vectorized non-decreasing integer function of position with
    ``g(lo) == 0``; requires ``0 <= r < g(hi)``.  Keeps ``g(l) <= r < g(h)``
    and returns ``l`` — a position of positive effective weight.
    """
    l, h = torch.broadcast_tensors(torch.as_tensor(lo), torch.as_tensor(hi))
    l, h = l.clone(), h.clone()
    for _ in range(iters):
        mid = (l + h) >> 1
        wide = (h - l) > 1
        take_right = wide & (g(mid) <= r)
        l = torch.where(take_right, mid, l)
        h = torch.where(wide & ~take_right, mid, h)
    return l

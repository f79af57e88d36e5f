"""Plain torch version of the interval-weight kernel (same formula).

Used on CPU tensors by ``ops.interval_weight`` and held against the CUDA
kernel on the card by ``chip_smoke.py``.
"""
from __future__ import annotations

import torch

from ...core.bisect import bisect_iters, seg_lower_bound, seg_upper_bound


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

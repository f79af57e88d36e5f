"""Plain torch version of the grouped-GEMM kernel.

The port of ``repro.kernels.segment_matmul.ref.segment_matmul_ref``:
row ``i`` of ``x [M, K]`` is multiplied by ``w[block_groups[i // bm]]``
(``bm = M // len(block_groups)``), the product accumulates in f32 and the
result is cast to ``x``'s dtype.  Unlike the jnp oracle it never builds
the ``[M, K, N]`` gather of weights: it multiplies one ``bm``-row block
at a time, or all blocks in one ``bmm`` when every group appears once in
order (the MoE layout, ``block_groups = arange(G)``).

Used on CPU tensors by ``ops.segment_matmul`` and held against the CUDA
kernel on the card by ``chip_smoke.py``.
"""
from __future__ import annotations

import torch


def segment_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       block_groups: torch.Tensor) -> torch.Tensor:
    """x ``[M, K]``, w ``[G, K, N]``, block_groups ``[nblocks]`` ->
    ``[M, N]`` in ``x.dtype``."""
    M, K = x.shape
    G, _, N = w.shape
    nb = block_groups.shape[0]
    bm = M // nb
    groups = block_groups.to(device=x.device, dtype=torch.int64)
    if nb == G and bool((groups == torch.arange(G, device=x.device)).all()):
        y = torch.bmm(x.float().reshape(G, bm, K), w.float())
        return y.reshape(M, N).to(x.dtype)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    for i, g in enumerate(groups.tolist()):
        rows = slice(i * bm, (i + 1) * bm)
        y[rows] = (x[rows].float() @ w[g].float()).to(x.dtype)
    return y

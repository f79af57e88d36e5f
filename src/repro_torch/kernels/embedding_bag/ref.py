"""Plain torch version of the EmbeddingBag kernel.

The function of ``repro.kernels.embedding_bag.ops.embedding_bag`` (the
wrapper and its Pallas kernel): a slot with ``idx < 0`` is padding and
adds nothing, a missing weight is 1, an id past the table reads its last
row (the clamp of the reference's gather), and each bag's weighted sum of
table rows is taken in f32 and rounded once to the table's dtype, as the
CUDA kernel does (the Pallas kernel rounds after every slot; for a bag of
one slot of weight 1 all of them return the table row bit for bit).

Used on CPU tensors by ``ops.embedding_bag`` and held against the CUDA
kernel on the card by ``chip_smoke.py``.
"""
from __future__ import annotations

import torch


def embedding_bag_ref(table: torch.Tensor, idx: torch.Tensor,
                      weights: torch.Tensor | None = None,
                      out_dtype=None) -> torch.Tensor:
    """table ``[V, d]``; idx ``[B, bag]`` (-1 = empty); weights ``[B, bag]``
    or None -> ``[B, d]`` in ``out_dtype`` (default ``table.dtype``)."""
    valid = idx >= 0
    w = (torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
         if weights is None else weights.float())
    w = torch.where(valid, w, 0.0)
    rows = table[idx.clamp(0, table.shape[0] - 1)].float()    # [B, bag, d]
    return (rows * w[..., None]).sum(dim=1).to(out_dtype or table.dtype)

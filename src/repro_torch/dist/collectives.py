"""The estimator mesh's shard index and combine (the port's copy of
``repro.dist.collectives.folded_axis_index``, and the counterpart of the
engine's ``jax.lax.psum``).

The reference's ``psum_chunked`` and ``sharded_embedding_lookup`` belong
to the model-side distribution slice.
"""
from __future__ import annotations

import torch


def folded_axis_index(mesh, axes, coords: dict) -> int:
    """Row-major linear shard index over ``axes`` of the shard at
    per-axis ``coords``: the 0-based index the engine strides its chunk
    round-robin by (shard ``d`` runs offsets ``d + i * D``); with one
    axis it is that axis's coordinate."""
    idx = int(coords[axes[0]])
    for a in axes[1:]:
        idx = idx * int(mesh.shape[a]) + int(coords[a])
    return idx


def combine(parts) -> torch.Tensor:
    """The exact int64 sum of the shards' window sums, copied to the
    host and added in shard order (integer addition: the order cannot
    change the total)."""
    total = None
    for part in parts:
        part = part.to("cpu", torch.int64)
        total = part if total is None else total + part
    return total

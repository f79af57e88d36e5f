"""Single-job execution engine: chunked sampling with exact int64 sums.

The single-job subset of ``repro.core.engine`` (``make_engine_window_fn``
/ ``plan_jobs`` / ``run_plan``): a job of ``k`` samples runs as
``n_chunks = ceil(k / chunk)`` chunks, so ``k_eff = n_chunks * chunk``
samples are drawn.  Chunk ``j`` draws from ``fold_in(PRNGKey(seed), j)``
— the chunk -> key map the reference keeps on any mesh — and reduces to
the six ``ACC_KEYS`` sums, accumulated as int64 tensors on the device.
The host reads them once per ``checkpoint_every``-chunk window (one
device sync per window); the keys of a window are made on the host and
moved to the device in one copy.

Not here (the reference's, to come in later slices of the port): tree
cohorts and stream fusion, meshes, checkpoint files, the retry ladder,
deadlines and witnesses.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from . import rng
from .sampler import make_sample_fn
from .spanning_tree import SpanningTree
from .validate import make_count_fn
from .weights import Weights

ACC_KEYS = ("cnt2", "valid", "fail_vmap", "fail_delta", "fail_order",
            "overflow")


@dataclass
class EngineRun:
    """What one job's sampling produced."""

    acc: dict           # ACC_KEYS -> exact int sums
    n_chunks: int
    k_eff: int          # samples drawn: n_chunks * chunk
    sampling_s: float   # host wall clock, device synced


def run_job(tree: SpanningTree, wts: Weights, dev: dict, k: int, seed: int,
            chunk: int = 8192, Lmax: int = 16,
            checkpoint_every: int = 64) -> EngineRun:
    """Draw ``k_eff`` samples of ``tree`` under ``wts`` and sum the counts.

    A job with ``W_total == 0`` has nothing to sample and returns zero
    sums for the full ``k_eff``, as the reference does.
    """
    n_chunks = max(1, -(-int(k) // chunk))
    acc = {kk: 0 for kk in ACC_KEYS}
    t0 = time.perf_counter()
    if int(wts.W_total) > 0:
        device = dev["t"].device
        s_fn = make_sample_fn(tree, chunk, device)
        c_fn = make_count_fn(tree, chunk, Lmax=Lmax)
        base = rng.PRNGKey(seed)
        for j0 in range(0, n_chunks, checkpoint_every):
            n = min(checkpoint_every, n_chunks - j0)
            keys = rng.fold_in(base, torch.arange(j0, j0 + n)).to(device)
            sums = torch.zeros(len(ACC_KEYS), dtype=torch.int64,
                               device=device)
            for i in range(n):
                out = c_fn(dev, wts, s_fn(dev, wts, keys[i]))
                sums += torch.stack([out[kk].sum() for kk in ACC_KEYS])
            for kk, v in zip(ACC_KEYS, sums.tolist()):
                acc[kk] += v
    return EngineRun(acc=acc, n_chunks=n_chunks, k_eff=n_chunks * chunk,
                     sampling_s=time.perf_counter() - t0)

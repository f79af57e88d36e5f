"""Spanning-tree sampling (paper Alg. 3), vectorized over K samples.

Torch counterpart of ``repro.core.sampler`` (its docstring holds the
design notes).  Every CDF is an int64 prefix sum of match counts and
every random target an int64 draw from the port's threefry RNG, so the
samples are bit-identical to the JAX reference for the same key.

Per sample: (1) window ``i ~ W_i / W`` by bisecting the window-prefix
CDF; (2) center edge by the two-piece (own|prev) inverse CDF over the
window's edge range; (3) children top-down along the static tree
schedule, each by the generalized inverse CDF over its alpha-CSR
segment minus the parallel-edge pair list (Claim 4.8).  The draws and
all three steps run in the tree-sampler op (``kernels/tree_sampler``):
on the card one kernel launch per chunk, handed the chunk key, which
draws its own threefry bits; on the CPU ``prepare_draws`` and the plain
twin.  The sampler reads only ``tree_signature`` fields of the tree.

A tree cohort (``core.engine``) draws one sample stream per seed and
scores it against every member motif: ``make_batched_sample_fn`` takes
the chunk keys of J streams at once (one kernel launch for all of
them), and ``make_cohort_count_fn`` runs each lane motif's own count fn
over the same ``[J, K]`` samples.
"""
from __future__ import annotations

import torch

from ..kernels.tree_sampler.ops import build_schedule, tree_sampler_keyed
from .estimator import ACC_KEYS
from .spanning_tree import SpanningTree
from .validate import make_count_fn


def vertex_map(tree: SpanningTree, dev: dict, edges: torch.Tensor
               ) -> torch.Tensor:
    """``phi_v [K, |V|]``: the graph vertex of every motif vertex, from
    the static ``vertex_source`` table."""
    cols = []
    for s_loc, end in tree.vertex_source:
        arr = dev["src"] if end == 0 else dev["dst"]
        cols.append(arr[edges[:, s_loc]].long())
    return torch.stack(cols, dim=1)


def make_sample_fn(tree: SpanningTree, K: int, device):
    """``fn(dev, wts, key) -> samples`` drawing K partial matches.

    Returns a dict with ``edges [K, S]`` (graph edge id per tree-local
    edge), ``window [K]`` and ``phi_v [K, |V|]``, all int64 on
    ``device``, where ``dev`` and ``wts`` must live.  ``key`` is a
    ``core.rng`` key ``[2]`` on any device; the draws are made on
    ``device``.  Given a ``[J, 2]`` key stack instead, every array gains
    a leading ``[J]`` stream axis (``make_batched_sample_fn``).
    """
    schedule = build_schedule(tree)
    device = torch.device(device)

    def fn(dev, wts, key):
        on = dev["t"].device
        if on.type != device.type or device.index not in (None, on.index):
            raise ValueError(f"sampler built for {device}, graph on "
                             f"{dev['t'].device}")
        edges, window = tree_sampler_keyed(schedule, tree.root,
                                           tree.num_edges, dev, wts,
                                           key.to(device), K)
        flat = edges.reshape(-1, tree.num_edges)
        phi_v = vertex_map(tree, dev, flat).reshape(*edges.shape[:-1], -1)
        return dict(edges=edges, window=window, phi_v=phi_v)

    return fn


def make_batched_sample_fn(tree: SpanningTree, K: int, device):
    """``fn(dev, wts, keys [J, 2]) -> samples`` with a leading ``[J]``
    stream axis: ``edges [J, K, S]``, ``window [J, K]``, ``phi_v [J, K,
    |V|]``, stream ``i`` bit-identical to a solo ``make_sample_fn`` call
    on ``keys[i]``.  One tree-sampler launch draws all J streams."""
    fn = make_sample_fn(tree, K, device)

    def batched(dev, wts, keys):
        if keys.dim() != 2:
            raise ValueError(f"keys must be [J, 2], got {tuple(keys.shape)}")
        return fn(dev, wts, keys)

    return batched


def make_cohort_count_fn(lane_trees, K: int, Lmax: int = 16,
                         keys: tuple = ACC_KEYS):
    """Score ONE shared sample batch against every lane motif.

    ``fn(dev, wts, samples) -> {key: [J, M] int64}``: ``samples`` is a
    ``make_batched_sample_fn`` batch and lane ``l`` runs its own tree's
    ``validate.make_count_fn`` over the same ``[J, K]`` samples (flattened
    to ``J * K`` rows: every count is per sample), each sum reduced over
    the chunk axis on the device.  The lanes share the samples and never
    a key: no lane index reaches the sampling keys (the reference's lint
    rule ``det-cohort-key``), so cell ``[i, l]`` is bit-identical to a
    solo run of lane ``l``'s motif on stream ``i``.
    """
    count_fns = tuple(make_count_fn(t, K, Lmax=Lmax) for t in lane_trees)

    def fn(dev, wts, samples):
        J = samples["edges"].shape[0]
        flat = {name: v.reshape(J * v.shape[1], *v.shape[2:])
                for name, v in samples.items()}
        outs = [cf(dev, wts, flat) for cf in count_fns]
        return {k: torch.stack([o[k].reshape(J, -1).sum(dim=1,
                                                         dtype=torch.int64)
                                for o in outs], dim=1)
                for k in keys}

    return fn

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
"""
from __future__ import annotations

import torch

from ..kernels.tree_sampler.ops import build_schedule, tree_sampler_keyed
from .spanning_tree import SpanningTree


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
    ``device``.
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
        return dict(edges=edges, window=window,
                    phi_v=vertex_map(tree, dev, edges))

    return fn

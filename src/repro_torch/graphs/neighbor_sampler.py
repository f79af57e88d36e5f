"""Fanout neighbor sampler for GNN minibatch training (GraphSAGE blocks).

The port's copy of ``repro.graphs.neighbor_sampler`` (host-side numpy
over an undirected CSR; given the same ``np.random.Generator`` it gives
the reference's blocks bit for bit):

    sampler = NeighborSampler(senders, receivers, n_nodes)
    batch   = sampler.sample_blocks(seed_nodes, fanouts=(15, 10), rng)

Returns the static-shape block format models/gnn.py consumes (deepest
block first, node table = [seeds | frontier-1 pads | frontier-2 pads]):

    feats   [n_table, F]   gathered rows of the global feature matrix
    blocks  [{senders, receivers}]  LOCAL indices into the node table;
            block i has exactly n_dst_i * fanout_rev_i edges (shape-
            static: missing neighbors repeat an existing one, isolated
            nodes self-loop)
    labels  [n_seed]
"""
from __future__ import annotations

import numpy as np


def _stable_order(u: np.ndarray, n: int) -> np.ndarray:
    """``np.argsort(u, kind="stable")`` for ids in ``[0, n)``: one sort of
    the distinct keys ``u << s | position`` (``s`` bits hold a position)
    gives the same order without the stable sort's merge passes; the
    stable argsort where the keys would not fit in 63 bits or an id is
    negative."""
    s = max(len(u) - 1, 1).bit_length()
    if max(n - 1, 1).bit_length() + s > 62 or (len(u) and u.min() < 0):
        return np.argsort(u, kind="stable")
    key = (u << s) | np.arange(len(u), dtype=np.int64)
    key.sort()
    return key & ((1 << s) - 1)


class NeighborSampler:
    def __init__(self, senders: np.ndarray, receivers: np.ndarray,
                 n_nodes: int):
        senders = np.asarray(senders, dtype=np.int64)
        receivers = np.asarray(receivers, dtype=np.int64)
        # undirected adjacency
        u = np.concatenate([senders, receivers])
        v = np.concatenate([receivers, senders])
        order = _stable_order(u, n_nodes)
        self.nbr = v[order]
        # the reference's np.add.at(ptr, u + 1, 1), as one bincount
        self.ptr = np.zeros(n_nodes + 1, dtype=np.int64)
        self.ptr[1:] = np.bincount(u, minlength=n_nodes)[:n_nodes]
        np.cumsum(self.ptr, out=self.ptr)
        self.n = n_nodes

    def sample_neighbors(self, nodes: np.ndarray, fanout: int,
                         rng: np.random.Generator) -> np.ndarray:
        """[len(nodes), fanout] sampled neighbor ids (self for isolated)."""
        lo = self.ptr[nodes]
        deg = self.ptr[nodes + 1] - lo
        pick = rng.integers(0, np.maximum(deg, 1),
                            size=(fanout, len(nodes))).T
        out = self.nbr[lo[:, None] + pick]
        return np.where(deg[:, None] > 0, out, nodes[:, None])

    def sample_blocks(self, seeds: np.ndarray, fanouts: tuple,
                      rng: np.random.Generator,
                      feats: np.ndarray | None = None,
                      labels: np.ndarray | None = None) -> dict:
        """L-layer block structure; fanouts[0] = the seed layer's fanout."""
        seeds = np.asarray(seeds, dtype=np.int64)
        # expand frontiers seed-side -> deepest
        frontiers = [seeds]
        for f in fanouts:
            cur = frontiers[-1]
            nb = self.sample_neighbors(cur, f, rng)            # [n_cur, f]
            frontiers.append(np.concatenate([cur, nb.reshape(-1)]))
        table = frontiers[-1]
        # blocks deepest-first; frontier i (size n_i) aggregates from
        # frontier i+1 (the table prefix of size n_{i+1})
        blocks = []
        for i in range(len(fanouts) - 1, -1, -1):
            n_dst = len(frontiers[i])
            f = fanouts[i]
            senders = np.arange(n_dst, n_dst + n_dst * f, dtype=np.int64)
            receivers = np.repeat(np.arange(n_dst, dtype=np.int64), f)
            blocks.append(dict(senders=senders, receivers=receivers))
        out = dict(blocks=blocks, node_ids=table)
        if feats is not None:
            out["feats"] = feats[table]
        if labels is not None:
            out["labels"] = labels[seeds]
        return out

"""The reference TIMEST estimator: plans (Alg. 7) and whole requests.

``Reference(src, dst, t)`` indexes the edges; ``plan(motif, delta)``
computes every candidate tree's ``W`` and keeps the first of least
``W``; ``run(requests, chunk)`` re-derives every chunk of every request
(chunk ``j`` from ``fold_in(PRNGKey(seed), j)``), sums the six counts
in int64 and unbiases (Alg. 6: ``W * cnt2 / 2k``).  Requests of one
tree signature, window and seed draw one sample stream, scored once per
motif.  ``dtype=torch.float32`` computes the weights in float32: the
benchmark's control.
"""
from __future__ import annotations

import torch

from . import rng
from .count import ACC_KEYS, chunk_sums, counts
from .graph import build_index, keys
from .motifs import candidates
from .sampler import sample
from .weights import weights


#: the program's defaults (``EstimateConfig``), which the mixes keep:
#: Alg. 7's candidates, roots per tree, and DeriveCnt's list cap
N_CANDIDATES, ROOTS_PER_TREE, LMAX = 3, 2, 16


class Reference:
    def __init__(self, src, dst, t, *, dtype=torch.int64):
        self.g = build_index(src, dst, t)
        self.k = keys(self.g)
        self.dtype = dtype
        self._W = {}          # (signature, delta) -> W
        self._plans = {}      # (motif, delta) -> (tree, weights)

    def plan(self, motif: str, delta: int):
        """``(tree, weights)`` of least ``W``, first among equals."""
        pkey = (motif, int(delta))
        if pkey not in self._plans:
            best = None
            for tree in candidates(motif, N_CANDIDATES, ROOTS_PER_TREE):
                wkey = (tree.signature, int(delta))
                w = None
                if wkey not in self._W:
                    w = weights(self.g, self.k, tree, delta, self.dtype)
                    self._W[wkey] = w.W
                if best is None or self._W[wkey] < best[0]:
                    best = (self._W[wkey], tree, w)
                del w
            W, tree, w = best
            if w is None:
                w = weights(self.g, self.k, tree, delta, self.dtype)
            self._plans[pkey] = (tree, w)
        return self._plans[pkey]

    def run(self, requests, chunk: int, on_chunk=None) -> list:
        """One result per request ``(motif, delta, k, seed)``: ``W``,
        ``tree_edges``, ``k`` (samples drawn), the six sums and
        ``estimate``.  ``on_chunk(tree, w, edges, window)`` sees every
        sampled chunk once."""
        out = [None] * len(requests)
        streams = {}
        for i, (motif, delta, k, seed) in enumerate(requests):
            tree, w = self.plan(motif, delta)
            n = max(1, -(-int(k) // chunk))
            out[i] = dict(motif=motif, W=w.W, tree_edges=tuple(tree.edges),
                          k=n * chunk, **{kk: 0 for kk in ACC_KEYS})
            if w.W > 0:
                streams.setdefault((tree.signature, int(delta), int(seed)),
                                   []).append((i, tree, w, n))
        for (_, _, seed), members in streams.items():
            base = rng.PRNGKey(seed, device=self.g["t"].device)
            for j in range(max(n for *_, n in members)):
                key = rng.fold_in(base, j)
                lead, w = members[0][1], members[0][2]
                edges, window = sample(self.g, self.k, lead, w, key, chunk,
                                       exact=self.dtype == torch.int64)
                if on_chunk is not None:
                    on_chunk(lead, w, edges, window)
                for (i, tree, w, n) in members:
                    if j < n:
                        c = chunk_sums(counts(self.g, self.k, tree, w,
                                              edges, LMAX))
                        for kk in ACC_KEYS:
                            out[i][kk] += c[kk]
        for r in out:
            r["estimate"] = r["W"] * r["cnt2"] / (2.0 * r["k"])
        return out

"""Temporal multigraph container (paper Sec. 4 preliminaries).

The port's own copy of the numpy host build of ``repro.core.graph``:
``TemporalGraph.from_edges`` gives the same arrays for the same edges.
``device_arrays(device)`` ships the index structure to torch tensors
with the dtypes the JAX package uses under x64: int64 times, pointers
and positions, int32 edge and vertex ids.

* edge arrays ``src/dst/t`` sorted globally by ``(t, src, dst)``;
* out-CSR: edges grouped by source, time-sorted inside each group;
* in-CSR: ditto by destination;
* pair-CSR: edges grouped by the ordered pair ``(src, dst)`` (the multi-edge
  lists ``El_{u,v}`` of Def. 4.2), time-sorted;
* cross-indices mapping each pair-CSR slot to its position inside the out-CSR
  of ``src`` and the in-CSR of ``dst`` (the Claim 4.8 exclusion);
* per-edge ``pair_id`` and ``rev_pair_id`` (the pair (dst,src), -1 if absent).

Timestamps are normalised to start at 0 (paper Sec. 4).  ``m_real`` is
the count of real edges: the weight DP zeroes the weights of entries
past it, so a graph padded with a suffix of pad edges (as the JAX
package's ``pad_snapshot`` builds) estimates exactly as the unpadded one.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class TemporalGraph:
    n: int                      # vertices
    m: int                      # temporal edges
    src: np.ndarray             # [m] int32, sorted by (t, id)
    dst: np.ndarray             # [m] int32
    t: np.ndarray               # [m] int64, non-decreasing, starts at 0
    # out-CSR (grouped by src, time-sorted within a group)
    out_ptr: np.ndarray         # [n+1] int64
    out_edge: np.ndarray        # [m] int32 edge ids
    out_t: np.ndarray           # [m] int64 = t[out_edge]
    # in-CSR (grouped by dst)
    in_ptr: np.ndarray
    in_edge: np.ndarray
    in_t: np.ndarray
    # pair-CSR (grouped by (src,dst))
    num_pairs: int
    pair_key: np.ndarray        # [P] sorted int64 keys src*n+dst
    pair_ptr: np.ndarray        # [P+1]
    pair_edge: np.ndarray       # [m]
    pair_t: np.ndarray          # [m]
    pair_id: np.ndarray         # [m] pair id of each edge
    rev_pair_id: np.ndarray     # [m] pair id of (dst,src) or -1
    pair_pos_out: np.ndarray    # [m] position of pair-CSR slot k inside out-CSR
    pair_pos_in: np.ndarray     # [m] ditto inside in-CSR
    # inverse permutations: position of edge e inside each CSR
    out_pos_of_edge: np.ndarray
    in_pos_of_edge: np.ndarray
    # real edge count of a padded graph (None when unpadded): entries
    # past ``m_real`` are zero-weight pad suffixes
    m_real: int | None = None

    @property
    def live_m(self) -> int:
        """Real (non-pad) edge count."""
        return self.m if self.m_real is None else self.m_real

    # ------------------------------------------------------------------
    @staticmethod
    def from_edges(src: np.ndarray, dst: np.ndarray, t: np.ndarray,
                   relabel: bool = True) -> "TemporalGraph":
        src = np.asarray(src)
        dst = np.asarray(dst)
        t = np.asarray(t, dtype=np.int64)
        if not (len(src) == len(dst) == len(t)):
            raise ValueError("edge array length mismatch")
        m = len(src)
        if m == 0:
            raise ValueError("empty graph")
        if np.any(src == dst):
            raise ValueError("self-loops not supported (match prior work)")
        if relabel:
            verts, inv = np.unique(np.concatenate([src, dst]), return_inverse=True)
            src = inv[:m].astype(np.int32)
            dst = inv[m:].astype(np.int32)
            n = len(verts)
        else:
            src = src.astype(np.int32)
            dst = dst.astype(np.int32)
            n = int(max(src.max(), dst.max())) + 1
        t = t - t.min()

        # enforce unique (u, v, t) tuples (paper's input model)
        tup = np.stack([src.astype(np.int64), dst.astype(np.int64), t], axis=1)
        uniq = np.unique(tup, axis=0)
        if len(uniq) != m:
            keep_idx = np.unique(
                src.astype(np.int64) * (n * (t.max() + 1))
                + dst.astype(np.int64) * (t.max() + 1) + t,
                return_index=True)[1]
            src, dst, t = src[keep_idx], dst[keep_idx], t[keep_idx]
            m = len(src)

        # global sort by (t, src, dst) — gives stable edge ids
        order = np.lexsort((dst, src, t))
        src, dst, t = src[order], dst[order], t[order]
        eid = np.arange(m, dtype=np.int32)

        def csr(group: np.ndarray, size: int):
            o = np.lexsort((eid, t, group))  # (group, t, id): time-sorted in-seg
            ptr = np.zeros(size + 1, dtype=np.int64)
            np.add.at(ptr, group.astype(np.int64) + 1, 1)
            np.cumsum(ptr, out=ptr)
            return ptr, eid[o].astype(np.int32), t[o]

        out_ptr, out_edge, out_t = csr(src, n)
        in_ptr, in_edge, in_t = csr(dst, n)

        # pair-CSR
        pkey = src.astype(np.int64) * n + dst.astype(np.int64)
        uniq_pairs, pair_id = np.unique(pkey, return_inverse=True)
        P = len(uniq_pairs)
        pair_ptr, pair_edge, pair_t = csr(pair_id.astype(np.int32), P)
        # reverse pair lookup
        rkey = dst.astype(np.int64) * n + src.astype(np.int64)
        ridx = np.searchsorted(uniq_pairs, rkey)
        ridx_clip = np.clip(ridx, 0, P - 1)
        rev_pair_id = np.where(uniq_pairs[ridx_clip] == rkey, ridx_clip, -1
                               ).astype(np.int32)

        out_pos_of_edge = np.empty(m, dtype=np.int64)
        out_pos_of_edge[out_edge] = np.arange(m)
        in_pos_of_edge = np.empty(m, dtype=np.int64)
        in_pos_of_edge[in_edge] = np.arange(m)
        pair_pos_out = out_pos_of_edge[pair_edge]
        pair_pos_in = in_pos_of_edge[pair_edge]

        return TemporalGraph(
            n=n, m=m, src=src, dst=dst, t=t,
            out_ptr=out_ptr, out_edge=out_edge, out_t=out_t,
            in_ptr=in_ptr, in_edge=in_edge, in_t=in_t,
            num_pairs=P, pair_key=uniq_pairs, pair_ptr=pair_ptr,
            pair_edge=pair_edge, pair_t=pair_t,
            pair_id=pair_id.astype(np.int32), rev_pair_id=rev_pair_id,
            pair_pos_out=pair_pos_out, pair_pos_in=pair_pos_in,
            out_pos_of_edge=out_pos_of_edge, in_pos_of_edge=in_pos_of_edge)

    # ------------------------------------------------------------------
    @property
    def time_span(self) -> int:
        return int(self.t[-1])

    def device_arrays(self, device: str | torch.device = "cuda"
                      ) -> dict[str, torch.Tensor]:
        """The index structure as torch tensors on ``device``.

        Dtypes follow the JAX package under x64: int64 times, pointers,
        pair keys and positions; int32 vertex and edge ids; ``n`` and
        ``m_real`` as 0-d int64 tensors.
        """
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device_arrays: no CUDA device; pass "
                               "device='cpu' to run on the CPU")

        def up(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a)).to(
                device=device, dtype=dtype)

        i32, i64 = torch.int32, torch.int64
        return dict(
            src=up(self.src, i32), dst=up(self.dst, i32),
            t=up(self.t, i64),
            out_ptr=up(self.out_ptr, i64), out_edge=up(self.out_edge, i32),
            out_t=up(self.out_t, i64),
            in_ptr=up(self.in_ptr, i64), in_edge=up(self.in_edge, i32),
            in_t=up(self.in_t, i64),
            n=torch.tensor(self.n, dtype=i64, device=device),
            pair_key=up(self.pair_key, i64),
            pair_ptr=up(self.pair_ptr, i64),
            pair_edge=up(self.pair_edge, i32),
            pair_t=up(self.pair_t, i64),
            pair_id=up(self.pair_id, i32),
            rev_pair_id=up(self.rev_pair_id, i32),
            pair_pos_out=up(self.pair_pos_out, i64),
            pair_pos_in=up(self.pair_pos_in, i64),
            # the weight DP zeroes pad-edge weights past it
            # (== m on unpadded graphs, so the mask is a no-op there)
            m_real=torch.tensor(self.live_m, dtype=i64, device=device),
        )

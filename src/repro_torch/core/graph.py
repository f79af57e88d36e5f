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

Timestamps are normalised to start at 0 (paper Sec. 4).

Padded snapshots (the stream's epochs): ``pad_snapshot`` grows every
array to a power-of-two bucket with a pure SUFFIX of pad entries, as
the reference's does.  Pad edges join two dedicated pad vertices (ids
above every real vertex) at the last real timestamp, so real entries
keep their positions in the global, out-, in- and pair-CSR orders.
``m_real`` (shipped in ``device_arrays``) makes the weight DP zero
pad-edge weights, so every prefix sum is flat across the pad suffix:
the samplers never select a pad edge, and estimates on a padded graph
equal the unpadded graph's bit for bit.  Torch compiles nothing, so the
buckets buy no program reuse here; they are kept so a snapshot's arrays
are the reference's array for array.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

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
    # padding metadata (``pad_snapshot``): None/False on unpadded graphs.
    # ``m_real``/``n_real``/``p_real`` are the live counts; entries past
    # them are zero-weight pad suffixes.  ``pad_windows`` asks
    # ``weights.preprocess`` to bucket the per-window arrays too.
    m_real: int | None = None
    n_real: int | None = None
    p_real: int | None = None
    pad_windows: bool = False

    @property
    def live_m(self) -> int:
        """Real (non-pad) edge count."""
        return self.m if self.m_real is None else self.m_real

    @property
    def live_n(self) -> int:
        return self.n if self.n_real is None else self.n_real

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

        # global sort by (t, src, dst) — gives stable edge ids
        order = np.lexsort((dst, src, t))
        # enforce unique (u, v, t) tuples (paper's input model): equal
        # tuples sit side by side in the sorted order.  This test stands
        # for the reference's np.unique(..., axis=0) row count (the same
        # answer, in a fraction of the host time of a stream's epoch);
        # duplicates take the reference's own dedup, then sort again.
        so, do, to = src[order], dst[order], t[order]
        if ((so[1:] == so[:-1]) & (do[1:] == do[:-1])
                & (to[1:] == to[:-1])).any():
            keep_idx = np.unique(
                src.astype(np.int64) * (n * (t.max() + 1))
                + dst.astype(np.int64) * (t.max() + 1) + t,
                return_index=True)[1]
            src, dst, t = src[keep_idx], dst[keep_idx], t[keep_idx]
            m = len(src)
            order = np.lexsort((dst, src, t))
            so, do, to = src[order], dst[order], t[order]
        src, dst, t = so, do, to
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

    def max_multiplicity(self, delta: int) -> int:
        """sigma_delta: max #edges between an ordered pair within any delta
        window.  Stops at ``p_real``: the pad pair's equal timestamps are
        not the graph's."""
        best = 1
        for p in range(self.num_pairs if self.p_real is None else self.p_real):
            seg = self.pair_t[self.pair_ptr[p]:self.pair_ptr[p + 1]]
            if len(seg) <= best:
                continue
            j = np.searchsorted(seg, seg - delta, side="left")
            best = max(best, int((np.arange(len(seg)) - j + 1).max()))
        return best

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


# ---------------------------------------------------------------------------
# power-of-two padded snapshots (the stream's epochs)
# ---------------------------------------------------------------------------
def next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()


def pad_bucket(x: int, floor: int = 1) -> int:
    """Smallest power-of-two >= max(x, floor)."""
    return max(next_pow2(int(floor)), next_pow2(int(x)))


def pad_snapshot(g: TemporalGraph, *, m_bucket: int | None = None,
                 n_bucket: int | None = None, p_bucket: int | None = None,
                 m_floor: int = 1, n_floor: int = 1, p_floor: int = 1,
                 pad_windows: bool = True) -> TemporalGraph:
    """Pad ``g`` to power-of-two array buckets (see the module docstring).

    Pad entries form a pure suffix of every array:

    * ``k = m_bucket - m`` pad edges run from pad vertex ``nb-2`` to
      ``nb-1`` at the last real timestamp: after every real edge in the
      global ``(t, src, dst)`` order, and grouped after every real
      vertex/pair in each CSR;
    * pad vertices ``n .. nb-1`` get empty CSR segments (except the two
      carrying the pad edges);
    * the pad edges form pair id ``P`` (key above every real key); the
      other ``p_bucket - P - 1`` pair slots are empty segments under
      sentinel keys ``>= nb*nb``, which no ``u*n + v`` lookup of real
      vertices can produce.

    Requires ``n_bucket >= g.n + 2`` (the default bucket guarantees it).
    Padding an already padded graph is refused.
    """
    if g.m_real is not None:
        raise ValueError("pad_snapshot: graph is already padded")
    n, m, P = g.n, g.m, g.num_pairs
    nb = pad_bucket(n + 2, n_floor) if n_bucket is None else int(n_bucket)
    mb = pad_bucket(m, m_floor) if m_bucket is None else int(m_bucket)
    pb = pad_bucket(P + 1, p_floor) if p_bucket is None else int(p_bucket)
    if nb < n + 2 or mb < m or pb < P + 1:
        raise ValueError(f"pad_snapshot: buckets (m={mb}, n={nb}, p={pb}) "
                         f"too small for graph (m={m}, n={n}, P={P})")
    k = mb - m
    t_max = int(g.t[-1])

    def suffix(a, fill):
        return np.concatenate([a, np.full(k, fill, dtype=a.dtype)])

    pad_eids = m + np.arange(k, dtype=np.int64)
    src = suffix(g.src, nb - 2)
    dst = suffix(g.dst, nb - 1)
    t = suffix(g.t, t_max)
    # out-CSR: pad edges belong to vertex nb-2; other pad vertices are empty
    out_ptr = np.full(nb + 1, m + k, dtype=np.int64)
    out_ptr[:n + 1] = g.out_ptr
    out_ptr[n + 1:nb - 1] = m
    out_edge = suffix(g.out_edge, 0)
    out_edge[m:] = pad_eids
    out_t = suffix(g.out_t, t_max)
    # in-CSR: pad edges belong to vertex nb-1
    in_ptr = np.full(nb + 1, m + k, dtype=np.int64)
    in_ptr[:n + 1] = g.in_ptr
    in_ptr[n + 1:nb] = m
    in_edge = suffix(g.in_edge, 0)
    in_edge[m:] = pad_eids
    in_t = suffix(g.in_t, t_max)
    # pair-CSR: real keys rebased to the padded multiplier (order-
    # preserving, so pair ids are unchanged); pad edges form pair P; the
    # remaining slots are empty segments under out-of-range sentinels
    pair_key = np.empty(pb, dtype=np.int64)
    pair_key[:P] = (g.pair_key // n) * nb + (g.pair_key % n)
    pair_key[P:] = (np.int64(nb) * np.int64(nb)
                    + np.arange(pb - P, dtype=np.int64))
    if k > 0:
        pair_key[P] = np.int64(nb - 2) * nb + (nb - 1)
    pair_ptr = np.full(pb + 1, m + k, dtype=np.int64)
    pair_ptr[:P + 1] = g.pair_ptr
    pair_edge = suffix(g.pair_edge, 0)
    pair_edge[m:] = pad_eids
    pair_t = suffix(g.pair_t, t_max)
    pair_id = suffix(g.pair_id, P)
    rev_pair_id = suffix(g.rev_pair_id, -1)
    pad_pos = m + np.arange(k, dtype=np.int64)

    return replace(
        g, n=nb, m=mb, src=src, dst=dst, t=t,
        out_ptr=out_ptr, out_edge=out_edge, out_t=out_t,
        in_ptr=in_ptr, in_edge=in_edge, in_t=in_t,
        num_pairs=pb, pair_key=pair_key, pair_ptr=pair_ptr,
        pair_edge=pair_edge, pair_t=pair_t, pair_id=pair_id,
        rev_pair_id=rev_pair_id,
        pair_pos_out=np.concatenate([g.pair_pos_out, pad_pos]),
        pair_pos_in=np.concatenate([g.pair_pos_in, pad_pos]),
        out_pos_of_edge=np.concatenate([g.out_pos_of_edge, pad_pos]),
        in_pos_of_edge=np.concatenate([g.in_pos_of_edge, pad_pos]),
        m_real=m, n_real=n, p_real=P, pad_windows=pad_windows)

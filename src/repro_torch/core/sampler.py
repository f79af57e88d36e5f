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

Telemetry: inside an engine window attempt at ``obs`` level ``trace``
each chunk opens the stage spans (``obs.stage``) ``sampler.draw`` (the
tree-sampler launch) and one ``validate.lane`` a count lane (attrs
``lane``, ``motif``), each with its CUDA-event ``device_ms`` on a card.
Below ``trace``, and for every other caller, ``obs.stage`` opens
nothing.

Witness capture (``make_witness_fn``) re-draws a counted chunk with the
counting path's key (on the card a second launch of the sampler kernel)
and keeps its accepted samples of least ``witness_priority``, a
splitmix64 hash of ``(seed, chunk, position)`` computed bit for bit as
the reference computes it in uint64.
"""
from __future__ import annotations

import torch

from .. import obs
from ..kernels.tree_sampler.ops import build_schedule, tree_sampler_keyed
from .estimator import ACC_KEYS
from .rng import _join64
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
        with obs.stage("sampler.draw"):
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
    solo run of lane ``l``'s motif on stream ``i``.  Each lane's count
    and sums run in the stage span ``validate.lane`` (attrs ``lane``,
    ``motif``).
    """
    count_fns = tuple(make_count_fn(t, K, Lmax=Lmax) for t in lane_trees)
    motifs = tuple(t.motif.name for t in lane_trees)

    def fn(dev, wts, samples):
        J = samples["edges"].shape[0]
        flat = {name: v.reshape(J * v.shape[1], *v.shape[2:])
                for name, v in samples.items()}
        lanes = []
        for lane, cf in enumerate(count_fns):
            with obs.stage("validate.lane", lane=lane, motif=motifs[lane]):
                o = cf(dev, wts, flat)
                lanes.append([o[k].reshape(J, -1).sum(dim=1,
                                                      dtype=torch.int64)
                              for k in keys])
        return {k: torch.stack([sums[i] for sums in lanes], dim=1)
                for i, k in enumerate(keys)}

    return fn


# ---------------------------------------------------------------------------
# witness extraction: deterministic per-chunk reservoir over accepted matches
# ---------------------------------------------------------------------------
#: int64 priority sentinel meaning "no accepted match in this slot":
#: reservoir rows carrying it are padding the host drops.
WITNESS_SENTINEL = (1 << 63) - 1

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1


def _words(x: torch.Tensor) -> tuple:
    """A uint64 bit pattern held in int64 -> its two uint32 words."""
    return (x >> 32) & _M32, x & _M32


def _add_const(hi, lo, c: int) -> tuple:
    """``(hi, lo) + c`` mod 2^64, on words (no sum reaches 2^34)."""
    lo = lo + (c & _M32)
    hi = (hi + (c >> 32) + (lo >> 32)) & _M32
    return hi, lo & _M32


def _shr(hi, lo, r: int) -> tuple:
    """Logical ``(hi, lo) >> r`` for ``0 < r < 32``."""
    return hi >> r, (lo >> r) | ((hi & ((1 << r) - 1)) << (32 - r))


def _mul_const(hi, lo, c: int) -> tuple:
    """``(hi, lo) * c`` mod 2^64, on 16-bit pieces so that no partial
    product reaches 2^63."""
    ch, cl = c >> 32, c & _M32
    a1, a0 = lo >> 16, lo & 0xFFFF
    b1, b0 = cl >> 16, cl & 0xFFFF
    mid = a1 * b0 + a0 * b1                         # < 2^33
    low = a0 * b0 + ((mid & 0xFFFF) << 16)           # < 2^33
    carry = a1 * b1 + (mid >> 16) + (low >> 32)      # hi word of lo * cl

    def mul_lo32(x, y: int):                         # (x * y) mod 2^32
        return (x * (y & 0xFFFF) + (((x * (y >> 16)) & 0xFFFF) << 16)) & _M32

    hi = (carry + mul_lo32(hi, cl) + mul_lo32(lo, ch)) & _M32
    return hi, low & _M32


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer over int64 tensors holding uint64 bit
    patterns: the same bijective hash as the reference's device
    ``splitmix64`` (uint64 lanes) and ``resilience.retry._splitmix64``,
    on 32-bit words with no signed wrap-around."""
    hi, lo = _add_const(*_words(x), 0x9E3779B97F4A7C15)
    for r, c in ((30, 0xBF58476D1CE4E5B9), (27, 0x94D049BB133111EB)):
        sh, sl = _shr(hi, lo, r)
        hi, lo = _mul_const(hi ^ sh, lo ^ sl, c)
    sh, sl = _shr(hi, lo, 31)
    return _join64(hi ^ sh, lo ^ sl)


def _as_u64(v, device) -> torch.Tensor:
    """A Python int taken mod 2^64, as its int64 bit pattern."""
    v = int(v) & _M64
    return torch.tensor(v - (1 << 64) if v >> 63 else v, dtype=torch.int64,
                        device=device)


def witness_priority(seed: int, j: int, K: int, device="cpu"
                     ) -> torch.Tensor:
    """Reservoir priorities for chunk ``j``: one int64 in
    ``[0, WITNESS_SENTINEL)`` per sample position, a pure function of
    ``(seed, chunk, position)`` (never the motif, cohort lane or device),
    equal to the reference's."""
    base = splitmix64(_as_u64(seed, device)
                      ^ splitmix64(_as_u64(j, device)))
    h = splitmix64(base ^ torch.arange(K, dtype=torch.int64, device=device))
    hi, lo = _shr(*_words(h), 1)
    return torch.clamp(_join64(hi, lo), max=WITNESS_SENTINEL - 1)


def make_witness_fn(tree: SpanningTree, K: int, device, Lmax: int = 16,
                    n_wit: int = 8):
    """``fn(dev, wts, key, j, seed) -> dict``: the chunk's top-``n_wit``
    accepted full-match witnesses by deterministic reservoir priority.

    The caller passes the SAME ``fold_in(base_key, j)`` key the counting
    path used for chunk ``j``, so the re-draw (on the card a second
    launch of the sampler kernel) gives exactly the instances the
    estimate counted; the count path is never touched.  Samples are
    scored with the tree's own count fn; of the accepted ones (``valid &
    ~overflow & cnt2 > 0``) the ``n_wit`` of least ``witness_priority``
    survive, rejected slots get the sentinel (a stable sort, as jax's).

    Returns ``prio [n]``, ``eids [n, S]`` (graph edge ids, tree-local
    order), ``src``/``dst``/``t [n, S]`` (gathered on the device, so the
    host pulls ``n_wit`` rows) and ``cnt2 [n]``, all int64.
    """
    s_fn = make_sample_fn(tree, K, device)
    c_fn = make_count_fn(tree, K, Lmax=Lmax)

    def fn(dev, wts, key, j, seed):
        samples = s_fn(dev, wts, key)
        out = c_fn(dev, wts, samples)
        accepted = out["valid"] & ~out["overflow"] & (out["cnt2"] > 0)
        on = samples["edges"].device
        prio = torch.where(accepted, witness_priority(seed, j, K, on),
                           WITNESS_SENTINEL)
        order = torch.argsort(prio, stable=True)[:n_wit]
        E = samples["edges"][order]                     # [n_wit, S]
        return dict(prio=prio[order], eids=E, src=dev["src"][E].long(),
                    dst=dev["dst"][E].long(), t=dev["t"][E].long(),
                    cnt2=out["cnt2"][order].long())

    return fn

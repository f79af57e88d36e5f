"""The dep-sum op (one whole Claim 4.9 dep-sum, less the Claim 4.8
exclusion) on the CPU, against the composition it replaces and against
the JAX reference's dep-sum through its Pallas interval-weight kernel
(interpret mode); then the schedules the CUDA kernels follow (edges
taken in meet-vertex order with their inputs gathered into it, group
searches in G + 1 parts), run in torch and held to the plain version."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.weights as rw
from repro.core.motif import get_motif as rget
from repro.core.spanning_tree import candidate_trees as rcands
from repro.graphs import powerlaw_temporal_graph as rgraph
from repro.kernels.interval_weight.ops import interval_weight as pallas_iw
from repro_torch.core.bisect import (bisect_iters, monotone_find,
                                     seg_lower_bound, seg_upper_bound)
from repro_torch.core.motif import get_motif
from repro_torch.core.spanning_tree import BEFORE, candidate_trees
from repro_torch.core.weights import ARRAY_FIELDS, num_windows, preprocess
from repro_torch.graphs import powerlaw_temporal_graph
from repro_torch.kernels.interval_weight.ops import (dep_sum, interval_weight,
                                                     kernel_arrays)
from repro_torch.kernels.interval_weight.ref import (dep_sum_queries,
                                                     dep_sum_ref, pair_ids)

GRAPH = dict(n=150, m=2000, time_span=40000, seed=11)
# few vertices, many edges each: most warps of 32 edges share a segment
DENSE = dict(n=40, m=4000, time_span=40000, seed=2)
DELTA = 3000
MOTIFS = ["M5-3", "M4-2"]


def _deps(graph, motif, use_c2):
    """Every (dependency, window, prefixes) the DP of the first candidate
    tree of ``motif`` evaluates, on its own CPU weights."""
    g = powerlaw_temporal_graph(**graph)
    tree = candidate_trees(get_motif(motif))[0]
    dev = g.device_arrays("cpu")
    w = preprocess(g, tree, DELTA, dev=dev, use_c2=use_c2, device="cpu")
    for s in tree.topo_down:
        for d in tree.deps[s]:
            c = d.child
            ps_csr = (w.ps_acc_own[c], w.ps_acc_prev[c])
            ps_pair = (w.ps_pair_own[c], w.ps_pair_prev[c]) if use_c2 \
                else None
            for window in ("own", "prev"):
                yield dev, d, window, w.wd, ps_csr, ps_pair


@pytest.mark.parametrize("use_c2", [True, False])
@pytest.mark.parametrize("motif", MOTIFS)
def test_dep_sum_equals_the_composition_it_replaces(motif, use_c2):
    """The op on CPU tensors is ``dep_sum_ref``: the five query arrays,
    two interval-weight sums, one subtraction."""
    for dev, d, window, wd, ps_csr, ps_pair in _deps(GRAPH, motif, use_c2):
        got = dep_sum(dev, d, window, DELTA, wd, ps_csr, ps_pair)
        qs = dep_sum_queries(dev, d, DELTA, wd, window, use_c2)
        csr_t, *q = qs["lam"]
        want = interval_weight(csr_t, *ps_csr, *q)
        if use_c2:
            pair_t, *q = qs["el"]
            want = want - interval_weight(pair_t, *ps_pair, *q)
        assert got.dtype == torch.int64 and torch.equal(got, want)
        assert torch.equal(
            dep_sum_ref(dev, d, window, DELTA, wd, ps_csr, ps_pair), got)


@pytest.mark.parametrize("use_c2", [True, False])
@pytest.mark.parametrize("motif", MOTIFS)
def test_dep_sum_equals_the_pallas_kernel_interpret(motif, use_c2):
    """Per dep-sum, the JAX Pallas kernel (interpret mode, int32 times,
    f32 prefixes: exact below 2^24, as on this graph) on the same
    queries; and the whole weight DP of the JAX package's ``pallas``
    backend, array for array."""
    for dev, d, window, wd, ps_csr, ps_pair in _deps(GRAPH, motif, use_c2):
        assert int(ps_csr[0][-1]) < 2 ** 24 and int(ps_csr[1][-1]) < 2 ** 24
        qs = dep_sum_queries(dev, d, DELTA, wd, window, use_c2)

        def jax_iw(vals, ps, q):
            args = ([jnp.asarray(vals.numpy(), jnp.int32)]
                    + [jnp.asarray(p.numpy(), jnp.float32) for p in ps]
                    + [jnp.asarray(a.numpy(), jnp.int32) for a in q])
            return np.asarray(pallas_iw(*args, bq=256, interpret=True))
        want = jax_iw(qs["lam"][0], ps_csr, qs["lam"][1:])
        if use_c2:
            want = want - jax_iw(qs["el"][0], ps_pair, qs["el"][1:])
        got = dep_sum(dev, d, window, DELTA, wd, ps_csr, ps_pair)
        assert np.array_equal(got.numpy(), want.astype(np.int64))

    rg = rgraph(**GRAPH)
    out = rw.make_preprocess_fn(rcands(rget(motif))[0], use_c2=use_c2,
                                backend="pallas")(
        rg.device_arrays(), DELTA, DELTA, num_windows(rg.time_span, DELTA))
    assert bool(out["exact"])
    got = preprocess(powerlaw_temporal_graph(**GRAPH),
                     candidate_trees(get_motif(motif))[0], DELTA,
                     use_c2=use_c2, device="cpu")
    for f in ARRAY_FIELDS:
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(out[f]).astype(np.int64)), f


def _kernel_order(dev, d, window, wd, ps_csr, ps_pair):
    """The CUDA kernel's schedule in torch: thread i takes edge
    ``perm[i]`` with its time, meet vertex and pair id read at ``i``,
    bisects the meet vertex's segment (phi from plo, brk inside [plo,
    phi]), skips an edge without a pair list, and stores at ``i``; the
    wrapper's gather by ``pos`` returns the result in edge order."""
    a = kernel_arrays(dev, d)
    m = dev["t"].shape[0]
    it = bisect_iters(m)
    t, meet, pid = a["perm_t"], a["meet"].long(), a["pid"].long()
    win = t // wd - int(window == "prev")
    if d.beta == BEFORE:
        tlo, thi = torch.maximum(t - DELTA, win * wd), t
    else:
        tlo, thi = t, torch.minimum(t + DELTA, (win + 2) * wd - 1)
    assert bool((tlo <= thi).all())
    brk = (win + 1) * wd

    def two_piece(vals, ps, lo, hi):
        plo = seg_lower_bound(vals, lo, hi, tlo, iters=it)
        phi = seg_upper_bound(vals, plo, hi, thi, iters=it)
        pmid = seg_lower_bound(vals, plo, phi, brk, iters=it)
        return (ps[0][pmid] - ps[0][plo]) + (ps[1][phi] - ps[1][pmid])
    w = two_piece(a["csr_t"], ps_csr, a["ptr"][meet], a["ptr"][meet + 1])
    if ps_pair is not None:
        has = pid >= 0
        pid0 = pid.clamp(min=0)
        el = two_piece(a["pair_t"], ps_pair, a["pair_ptr"][pid0],
                       a["pair_ptr"][pid0 + 1])
        w = w - torch.where(has, el, 0)
    return w[a["pos"]]


@pytest.mark.parametrize("use_c2", [True, False])
@pytest.mark.parametrize("motif", MOTIFS)
def test_kernel_schedule_gives_the_plain_dep_sum(motif, use_c2):
    """Meet-vertex order changes no bit; ``perm`` groups each meet
    vertex's edges in one run of ascending times, and the gathered inputs
    are the edges' own."""
    for dev, d, window, wd, ps_csr, ps_pair in _deps(DENSE, motif, use_c2):
        a = kernel_arrays(dev, d)
        e = dev["out_edge" if d.meet_end == 0 else "in_edge"].long()
        assert torch.equal(a["pos"][e], torch.arange(e.shape[0]))
        assert torch.equal(a["perm_t"], dev["t"][e])
        meet_of = dev["src"] if d.meet_end == 0 else dev["dst"]
        assert torch.equal(a["meet"], meet_of[e])
        assert torch.equal(a["pid"], pair_ids(dev, d)[e])
        meet = a["meet"]
        assert bool((meet[1:] >= meet[:-1]).all())
        run = meet[1:] == meet[:-1]
        assert bool((a["perm_t"][1:][run] >= a["perm_t"][:-1][run]).all())
        got = _kernel_order(dev, d, window, wd, ps_csr, ps_pair)
        assert torch.equal(got,
                           dep_sum_ref(dev, d, window, DELTA, wd, ps_csr,
                                       ps_pair))
        assert torch.equal(
            dep_sum(dev, d, window, DELTA, wd, ps_csr, ps_pair, a), got)


def test_dep_sum_refuses_malformed_arrays():
    """Gathered inputs given by the caller are checked before any pointer
    is taken: a missing array, a wrong length, a wrong dtype."""
    dev, d, window, wd, ps_csr, ps_pair = next(_deps(GRAPH, "M5-3", True))
    a = kernel_arrays(dev, d)
    bad = ({k: v for k, v in a.items() if k != "pid"},
           dict(a, meet=a["meet"][:-1]),
           dict(a, pos=a["pos"].int()))
    for arrays in bad:
        with pytest.raises(ValueError, match="dep_sum"):
            dep_sum(dev, d, window, DELTA, wd, ps_csr, ps_pair, arrays)


def _group_first_true(l, h, pred, G):
    """``group_first_true`` of ``kernels/csrc/bisect.cuh``, one group."""
    while l < h:
        n = h - l
        if n <= G:
            hits = [j for j in range(min(n, G)) if pred(l + j)]
            return l + hits[0] if hits else h
        hits = [j for j in range(G) if pred(l + n * (j + 1) // (G + 1))]
        if hits:
            j = hits[0]
            hit = l + n * (j + 1) // (G + 1)
            if j > 0:
                l = l + n * j // (G + 1) + 1
            h = hit
        else:
            l = l + n * G // (G + 1) + 1
    return l


@pytest.mark.parametrize("G", [8, 16, 32])
def test_group_search_order_gives_the_bisection_answer(G):
    """The kernels' G-ary ballot search, step for step in Python: the
    bounds and inverse CDF of ``core/bisect.py`` on random sorted
    segments, empty and inverted ranges, and targets past both ends."""
    r = np.random.default_rng(G)
    vals = torch.as_tensor(np.sort(r.integers(0, 400, 3000)))
    cum = torch.cat([torch.zeros(1, dtype=torch.int64),
                     torch.cumsum(torch.as_tensor(r.integers(0, 3, 3000)),
                                  0)])
    it = bisect_iters(3000)
    for _ in range(300):
        lo, hi = sorted(int(v) for v in r.integers(0, 3001, 2))
        if r.random() < 0.1:
            lo, hi = hi, lo
        x = int(r.integers(-5, 405))
        for upper in (False, True):
            want = (seg_upper_bound if upper else seg_lower_bound)(
                vals, torch.tensor(lo), torch.tensor(hi), torch.tensor(x),
                iters=it)
            got = _group_first_true(
                lo, hi, lambda p: bool(vals[min(max(p, 0), 2999)] > x
                                       if upper else
                                       vals[min(max(p, 0), 2999)] >= x), G)
            assert got == int(want)
        span = int(cum[hi] - cum[lo]) if hi > lo else 0
        rx = int(r.integers(0, max(span, 1)))
        want = monotone_find(lambda p: cum[p] - cum[lo], torch.tensor(lo),
                             torch.tensor(hi), torch.tensor(rx), iters=it)
        got = lo if hi - lo <= 1 else _group_first_true(
            lo + 1, hi, lambda p: int(cum[p] - cum[lo]) > rx, G) - 1
        assert got == int(want)

"""The port's sampler (draws, the tree-sampler op's plain version, the
vertex map) against the JAX package's, bit for bit."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import repro.core.weights as rw
from repro.core.motif import get_motif as rget
from repro.core.sampler import _make_sample_fn_xla
from repro.core.spanning_tree import candidate_trees as rcands
from repro.graphs import powerlaw_temporal_graph as rgraph
from repro.kernels.tree_sampler.ops import prepare_draws as jax_draws
from repro.kernels.tree_sampler.ref import tree_sampler_ref as jax_ref
from repro_torch.core import rng
from repro_torch.core.motif import get_motif as tget
from repro_torch.core.sampler import make_sample_fn
from repro_torch.core.spanning_tree import candidate_trees as tcands
from repro_torch.core.weights import ARRAY_FIELDS, preprocess, weights_from_numpy
from repro_torch.graphs import powerlaw_temporal_graph as tgraph
from repro_torch.kernels.tree_sampler.ops import (build_schedule,
                                                  prepare_draws,
                                                  tree_sampler)

GRAPH = dict(n=120, m=1500, time_span=30000, seed=5)
DELTA = 3000
K = 513          # deliberately ragged


@pytest.fixture(scope="module")
def setup():
    rg, tg = rgraph(**GRAPH), tgraph(**GRAPH)
    return rg, rg.device_arrays(), tg, tg.device_arrays("cpu")


def _case(setup, motif, use_c2, cand=0):
    rg, rdev, tg, tdev = setup
    rtree = rcands(rget(motif))[cand]
    ttree = tcands(tget(motif))[cand]
    rwts = rw.preprocess(rg, rtree, DELTA, dev=rdev, use_c2=use_c2,
                         backend="xla")
    twts = weights_from_numpy(
        ttree, rwts.delta, rwts.wd, int(rwts.q), rwts.use_c2,
        {f: np.asarray(getattr(rwts, f)) for f in ARRAY_FIELDS}, "cpu")
    return rtree, rdev, rwts, ttree, tdev, twts


def _i64(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.int64) if a.dtype == np.uint64 else a.astype(np.int64)


@pytest.mark.parametrize("use_c2", [True, False])
@pytest.mark.parametrize("motif", ["M5-3", "M4-2"])
def test_draws_and_plain_sampler_match_reference(setup, motif, use_c2):
    """``prepare_draws`` gives jax's draws; on identical draws the op's
    plain version gives ``tree_sampler_ref``'s edges and windows."""
    rtree, rdev, rwts, ttree, tdev, twts = _case(setup, motif, use_c2)
    for seed, j in [(0, 0), (3, 7)]:
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), j)
        tkey = rng.fold_in(rng.PRNGKey(seed), j)
        jx, juhi, julo = jax_draws(rtree, rwts, jkey, K)
        x, uhi, ulo = prepare_draws(ttree, twts, tkey, K)
        for a, b in ((x, jx), (uhi, juhi), (ulo, julo)):
            assert np.array_equal(a.numpy(), _i64(b))
        want = jax_ref(rtree, rdev, rwts, jx, juhi, julo)
        edges, window = tree_sampler(build_schedule(ttree), ttree.root,
                                     ttree.num_edges, tdev, twts, x, uhi,
                                     ulo)
        assert np.array_equal(edges.numpy(), _i64(want["edges"]))
        assert np.array_equal(window.numpy(), _i64(want["window"]))


@pytest.mark.parametrize("use_c2", [True, False])
@pytest.mark.parametrize("motif", ["M5-3", "M4-2"])
def test_sample_fn_matches_xla_sampler(setup, motif, use_c2):
    """Same key -> same ``edges``, ``window`` and ``phi_v`` as the
    reference's exact-int64 XLA sampler."""
    rtree, rdev, rwts, ttree, tdev, twts = _case(setup, motif, use_c2)
    x_fn = _make_sample_fn_xla(rtree, K)
    t_fn = make_sample_fn(ttree, K, "cpu")
    for seed in (0, 9):
        want = x_fn(rdev, rwts, jax.random.PRNGKey(seed))
        got = t_fn(tdev, twts, rng.PRNGKey(seed))
        for f in ("edges", "window", "phi_v"):
            assert got[f].dtype == torch.int64
            assert np.array_equal(got[f].numpy(), _i64(want[f])), f


def test_port_weights_feed_the_same_samples(setup):
    """The port's own DP output drives the sampler to the same samples
    as the reference weights carried across with ``weights_from_numpy``."""
    rg, rdev, tg, tdev = setup
    rtree, rdev, rwts, ttree, tdev, carried = _case(setup, "M5-3", True, 1)
    own = preprocess(tg, ttree, DELTA, dev=tdev)
    fn = make_sample_fn(ttree, K, "cpu")
    key = rng.PRNGKey(4)
    a, b = fn(tdev, own, key), fn(tdev, carried, key)
    for f in ("edges", "window", "phi_v"):
        assert torch.equal(a[f], b[f])


def test_schedule_matches_reference_kernel_schedule():
    from repro.kernels.tree_sampler.kernel import build_schedule as rbs
    for name in ("M5-3", "M4-2", "M6-4", "M5-5"):
        for rt, tt in zip(rcands(rget(name)), tcands(tget(name))):
            assert build_schedule(tt) == tuple(
                (s, c, me, a, b, int(u)) for (s, c, me, a, b, u) in rbs(rt))


def test_sampler_checks_its_device():
    tg = tgraph(n=40, m=200, time_span=2000, seed=1)
    tree = tcands(tget("M4-2"))[0]
    dev = tg.device_arrays("cpu")
    wts = preprocess(tg, tree, 500, dev=dev)
    with pytest.raises(ValueError, match="sampler built for"):
        make_sample_fn(tree, 8, "meta")(dev, wts, rng.PRNGKey(0))

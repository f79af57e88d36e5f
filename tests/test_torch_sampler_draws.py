"""The tree sampler's in-kernel draw schedule, on the CPU: ``draws_at``
computes each sample's draws from its own index, as the CUDA kernel
derives them from the chunk key, and must give ``prepare_draws``'s rows
(itself held to ``jax.random`` in ``test_torch_sampler.py``) for window
totals on both sides of 2^32, where jax's randint reduction wraps."""
from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.weights  # noqa: F401  (turns on jax x64, as the reference runs)
from repro_torch.core import rng
from repro_torch.core.motif import get_motif
from repro_torch.core.spanning_tree import candidate_trees
from repro_torch.core.weights import preprocess
from repro_torch.graphs import powerlaw_temporal_graph
from repro_torch.kernels.tree_sampler.ops import (build_schedule, draws_at,
                                                  prepare_draws,
                                                  tree_sampler,
                                                  tree_sampler_keyed)

K = 3000
# W of 0 and 1, below 2^32, at it, and past it (mult wraps to 0 there)
TOTALS = [0, 1, 412857, 2 ** 32 - 5, 2 ** 32, 2 ** 32 + 1, 2 ** 40 + 7,
          2 ** 62 - 3]


def _idx(seed: int, n: int = 200) -> torch.Tensor:
    r = np.random.default_rng(seed)
    return torch.as_tensor(np.concatenate([[0, K - 1],
                                           r.integers(0, K, n)]))


@pytest.mark.parametrize("W", TOTALS)
@pytest.mark.parametrize("motif", ["M5-3", "M4-2"])
def test_draws_at_equals_prepare_draws_rows(motif, W):
    tree = candidate_trees(get_motif(motif))[1]
    wts = SimpleNamespace(W_total=torch.tensor(W, dtype=torch.int64))
    key = rng.fold_in(rng.PRNGKey(5), 17)
    full = prepare_draws(tree, wts, key, K)
    idx = _idx(W % 1000)
    got = draws_at(tree, wts, key, idx)
    for a, b in zip(got, full):
        assert a.dtype == torch.int64 and torch.equal(a, b[idx])
    assert int(full[0].max()) < max(W, 1)
    assert (full[0] >= 2 ** 32).any() == (W > 2 ** 33)


@pytest.mark.parametrize("seed", [0, 2 ** 40 + 3])
def test_bits_at_are_jax_bits_at_those_counters(seed):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    tk = rng.fold_in(rng.PRNGKey(seed), 3)
    want = np.asarray(jax.random.bits(jk, (K,), jnp.uint64)).view(np.int64)
    idx = _idx(seed % 97)
    assert np.array_equal(rng.bits_at(tk, idx).numpy(), want[idx.numpy()])


@pytest.mark.parametrize("use_c2", [True, False])
def test_keyed_sampler_on_cpu_is_prepare_draws_then_plain(use_c2):
    """The kernel wrapper's CPU path: the draws of ``prepare_draws`` fed
    to the plain version, and no launch counted."""
    g = powerlaw_temporal_graph(n=120, m=1500, time_span=30000, seed=5)
    tree = candidate_trees(get_motif("M5-3"))[0]
    dev = g.device_arrays("cpu")
    wts = preprocess(g, tree, 3000, dev=dev, use_c2=use_c2, device="cpu")
    schedule = build_schedule(tree)
    args = (schedule, tree.root, tree.num_edges, dev, wts)
    key = rng.fold_in(rng.PRNGKey(2), 9)
    before = tree_sampler_keyed.launches
    for n in (1, 257):
        got = tree_sampler_keyed(*args, key, n)
        want = tree_sampler(*args, *prepare_draws(tree, wts, key, n))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tree_sampler_keyed.launches == before
    other = tree_sampler_keyed(*args, rng.fold_in(rng.PRNGKey(2), 10), 257)
    assert not torch.equal(other[0], got[0])

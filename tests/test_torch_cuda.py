"""The port's CUDA kernels on the card against their plain versions.

Marked ``cuda``: each test skips (inside the ``cuda_device`` fixture)
where there is no GPU.  On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Only the port is imported here, so the file also runs where jax is not
installed.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch import estimate, get_motif, powerlaw_temporal_graph
from repro_torch.core import rng
from repro_torch.core.spanning_tree import candidate_trees
from repro_torch.core.weights import dep_sum_queries, preprocess
from repro_torch.kernels.interval_weight.ops import interval_weight
from repro_torch.kernels.interval_weight.ref import interval_weight_ref
from repro_torch.kernels.tree_sampler.ops import (build_schedule,
                                                  prepare_draws,
                                                  tree_sampler)
from repro_torch.kernels.tree_sampler.ref import tree_sampler_ref

pytestmark = pytest.mark.cuda

GRAPH = dict(n=400, m=6000, time_span=60000, seed=3)
FIELDS = ("estimate", "W", "k", "cnt2_sum", "valid", "fail_vmap",
          "fail_delta", "fail_order", "overflow", "tree_edges")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("motif", ["M5-3", "M4-2"])
@pytest.mark.parametrize("use_c2", [True, False])
def test_kernels_equal_plain_versions(cuda_device, motif, use_c2):
    g = powerlaw_temporal_graph(**GRAPH)
    tree = candidate_trees(get_motif(motif))[0]
    dev = g.device_arrays(cuda_device)
    wts = preprocess(g, tree, 2000, dev=dev, use_c2=use_c2)
    for d in tree.deps[tree.root]:
        for window in ("own", "prev"):
            qs = dep_sum_queries(dev, d, wts.delta, wts.wd, window, True)
            csr_t, *q = qs["lam"]
            args = (csr_t, wts.ps_acc_own[d.child].contiguous(),
                    wts.ps_acc_prev[d.child].contiguous(), *q)
            n = interval_weight.launches
            assert torch.equal(interval_weight(*args),
                               interval_weight_ref(*args))
            assert interval_weight.launches == n + 1
    x, uhi, ulo = prepare_draws(tree, wts, rng.PRNGKey(1).to(cuda_device),
                                777)
    args = (build_schedule(tree), tree.root, tree.num_edges, dev, wts, x,
            uhi, ulo)
    n = tree_sampler.launches
    e_k, w_k = tree_sampler(*args)
    e_r, w_r = tree_sampler_ref(*args)
    torch.cuda.synchronize()
    assert tree_sampler.launches == n + 1
    assert torch.equal(e_k, e_r) and torch.equal(w_k, w_r)


@pytest.mark.parametrize("motif,k,seed", [("M5-3", 1024, 0),
                                          ("M4-2", 512, 3)])
def test_card_estimate_equals_cpu(cuda_device, motif, k, seed):
    g = powerlaw_temporal_graph(**GRAPH)
    kw = dict(seed=seed, chunk=256)
    card = estimate(g, get_motif(motif), 2000, k, device=cuda_device, **kw)
    cpu = estimate(g, get_motif(motif), 2000, k, device="cpu", **kw)
    for f in FIELDS:
        assert getattr(card, f) == getattr(cpu, f), f

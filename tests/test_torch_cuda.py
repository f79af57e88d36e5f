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


# -- the LM serving path -------------------------------------------------
FA_CUDA_CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, causal, window, softcap): the six cases of
    # tests/test_kernels.py, ragged lengths, and every head dim
    (1, 128, 128, 4, 2, 32, True, 0, 0.0),
    (2, 256, 256, 4, 4, 64, True, 0, 0.0),
    (1, 256, 256, 8, 2, 32, True, 64, 0.0),
    (1, 128, 128, 4, 2, 32, True, 0, 50.0),
    (1, 128, 256, 4, 2, 32, False, 0, 0.0),
    (2, 384, 384, 6, 3, 64, True, 128, 30.0),
    (1, 200, 200, 4, 2, 16, True, 48, 50.0),
    (2, 70, 130, 2, 1, 128, False, 0, 0.0),
    (1, 333, 333, 4, 2, 256, True, 100, 50.0),
]


@pytest.mark.parametrize("case", FA_CUDA_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_attention_kernel_equals_plain_version(cuda_device, case,
                                                     dtype, tol):
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    B, Sq, Skv, Hq, Hkv, D, causal, window, cap = case
    g = torch.Generator(device=cuda_device).manual_seed(Sq + D)
    q, k, v = (torch.randn(s, generator=g, device=cuda_device).to(dtype)
               for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    kw = dict(causal=causal, window=window, attn_softcap=cap)
    n = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    torch.testing.assert_close(got, flash_attention_ref(q, k, v, **kw),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ["gemma2-27b", "granite-8b",
                                  "deepseek-7b"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
def test_card_lm_equals_cpu(cuda_device, arch, dtype, tol):
    """Prefill (through the flash kernel) and 3 decode steps, card
    against CPU on the same numpy weights; f32 without TF32."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.convert import lm_from_numpy, numpy_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    params = numpy_params(cfg, seed=3)
    tokens = torch.as_tensor(
        np.random.default_rng(3).integers(0, cfg.vocab, (2, 23)))
    runs = []
    for device in ("cpu", cuda_device):
        model = lm_from_numpy(cfg, params, device=device)
        tok = tokens.to(device)
        n = flash_attention.launches
        logits, cache = model.prefill(tok[:, :20], 24, compute_dtype=dtype)
        out = [logits]
        for s in range(20, 23):
            logits, cache = model.decode_step(cache, tok[:, s:s + 1],
                                              compute_dtype=dtype)
            out.append(logits)
        launches = flash_attention.launches - n
        assert launches == (cfg.n_layers if device != "cpu" else 0)
        runs.append([x.cpu() for x in out] + [cache["k"].cpu()])
    for card, cpu in zip(runs[1], runs[0]):
        torch.testing.assert_close(card, cpu, atol=tol, rtol=tol)

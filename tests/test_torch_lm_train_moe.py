"""LM training of the port against ``repro.models.transformer``: the MoE
smoke configs (qwen2-moe-a2.7b, granite-moe-3b-a800m) and the grouped
GEMM's gradient.

* ``train_loss`` and its autograd gradient against
  ``jax.value_and_grad`` of the reference's loss on the same numpy tree
  and batch: f32 (remat on in both) within 1e-5 in relative L2 per leaf;
  bf16 within 5e-2.  In bf16 a one-ulp difference flips a top-k choice
  at a near tie (ROADMAP §3), so the reference's expert choices are
  recorded (a ``jax.debug.callback`` in its ``route``; remat off on both
  sides, so each layer routes once) and handed to the port, whose gates
  and aux come from its own router probabilities at those experts (the
  router's gradient stays the port's own).  Wherever the port's own
  top-k differs, its router must have seen a near tie (``ROUTE_TIE``).
* remat on equals remat off, bit for bit.
* ``SegmentMatmulFn``'s gradient (dX through the grouped GEMM on the
  transposed weights, dW per block) against the autograd of the plain
  grouped product, for the MoE layout and for repeated, unordered groups.
* three ``make_train_step`` steps against the reference's jitted step in
  f32, within 1e-5.
"""
from __future__ import annotations

import collections
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import moe as jm
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.segment_matmul.ref import segment_matmul_ref
from repro_torch.models import moe as tm
from repro_torch.testing import ROUTE_TIE
from test_torch_lm_train_dense import (hold_loss_and_grads,
                                       hold_remat_on_equals_off,
                                       hold_three_steps, rel_l2)

MOE = ("qwen2-moe-a2.7b", "granite-moe-3b-a800m")


@pytest.fixture
def pinned(monkeypatch):
    """Records the reference's experts per ``route`` call and routes the
    port's calls, in the same order, to them; returns the queue."""
    queue = collections.deque()
    ref_route = jm.route

    def record(cfg, h2, w):
        gates, experts, aux = ref_route(cfg, h2, w)
        jax.debug.callback(lambda e: queue.append(np.array(e)), experts,
                           ordered=True)
        return gates, experts, aux

    def route(cfg, h2, w):
        probs = tm.router_probs(h2, w)
        own = torch.topk(probs, cfg.top_k, dim=-1).indices
        experts = torch.as_tensor(queue.popleft()).long()
        flip = (own.sort(-1).values != experts.sort(-1).values).any(-1)
        if bool(flip.any()):
            top = torch.topk(probs.detach()[flip], cfg.top_k + 1, -1).values
            gap = top[:, -2] - top[:, -1]
            assert bool((gap < ROUTE_TIE).all()), f"no near tie: {gap}"
        gates, aux = tm.gates_and_aux(cfg, probs, experts)
        return gates, experts, aux

    monkeypatch.setattr(jm, "route", record)
    monkeypatch.setattr(tm, "route", route)
    return queue


def hold(cfg, jcfg, dtype):
    grads = dict(hold_loss_and_grads(cfg, jcfg, dtype))
    assert bool(grads["['layers']['router']"].any())    # the router learns


@pytest.mark.parametrize("arch", MOE)
def test_loss_and_grads_match_reference_f32(arch):
    cfg, jcfg = get_smoke_config(arch), jax_smoke(arch)
    assert cfg.remat and jcfg.remat
    hold(cfg, jcfg, "float32")


@pytest.mark.parametrize("arch", MOE)
def test_loss_and_grads_match_reference_bf16(arch, pinned):
    cfg = dataclasses.replace(get_smoke_config(arch), remat=False)
    jcfg = dataclasses.replace(jax_smoke(arch), remat=False)
    hold(cfg, jcfg, "bfloat16")
    assert not pinned                      # every recorded route consumed


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", MOE)
def test_remat_on_equals_off(arch, dtype):
    hold_remat_on_equals_off(arch, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [[0, 1, 2, 3], [2, 0, 2, 1]])
def test_segment_matmul_fn_grad_matches_plain_autograd(groups, dtype):
    """4 blocks of 8 rows over 4 groups, K 24, N 40: dX and dW against
    the autograd of ``segment_matmul_ref`` on f32 copies (f32 within
    1e-6; bf16 within 1e-2: dW's blocks are rounded to bf16 before a
    repeated group sums them); a group no block uses gets a zero dW."""
    r = np.random.default_rng(7)
    x, dy = (torch.as_tensor(r.standard_normal(s), dtype=torch.float32)
             for s in ((32, 24), (32, 40)))
    w = torch.as_tensor(r.standard_normal((4, 24, 40)) / 5,
                        dtype=torch.float32)
    x, w, dy = (t.to(dtype) for t in (x, w, dy))
    bg = torch.tensor(groups, dtype=torch.int32)
    a, b = (t.clone().requires_grad_() for t in (x, w))
    y = tm.SegmentMatmulFn.apply(a, b, bg)
    got = torch.autograd.grad(y, (a, b), dy)
    c, d = (t.float().requires_grad_() for t in (x, w))
    want = torch.autograd.grad(segment_matmul_ref(c, d, bg), (c, d),
                               dy.float())
    assert torch.equal(y, segment_matmul_ref(x, w, bg))
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    for g, h, t in zip(got, want, (x, w)):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert rel_l2(g.float().numpy(), h.numpy()) <= tol
    unused = sorted(set(range(4)) - set(groups))
    assert not bool(got[1][unused].any())


def test_three_train_steps_match_reference():
    hold_three_steps("granite-moe-3b-a800m")

"""LM training of the port against ``repro.models.transformer``: the
dense smoke configs (granite-8b, gemma2-27b, deepseek-7b) and the
attention seam.

* ``train_loss`` and its autograd gradient against
  ``jax.value_and_grad`` of the reference's loss on the same numpy tree
  and batch (remat on in both): in f32 (the reference's ``forward(...,
  compute_dtype=float32)`` plus ``softmax_xent`` plus the aux term) the
  loss and every leaf within 1e-5 in relative L2, PERF.md's training
  tolerance; in bf16 within 5e-2, the bf16 tolerance of the LM tests.
* remat on equals remat off, bit for bit (the recompute is the same CPU
  arithmetic).
* ``attention_blockwise`` against the reference's jnp
  ``attention_flash`` (forward and ``jax.grad``), and the gradient of
  ``FlashAttentionFn`` against the autograd of ``attention_blockwise``:
  causal, window, softcap, non-causal, G in {1, 2, 3}.
* three ``make_train_step`` steps (AdamW, accumulation over two
  microbatches) against the reference's jitted step, within 1e-5.
* ``LMConfig.param_count`` / ``active_param_count`` equal the
  reference's for the five LM configs.

The MoE configs are in ``test_torch_lm_train_moe.py`` (which shares
this file's helpers): one worker compiling every reference program has
run out of memory before.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as ja
from repro.models import transformer as jt
from repro.models.layers import softmax_xent as jax_xent
from repro.train import optimizer as jo
from repro.train import steps as js
from repro_torch import testing
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import attention as ta
from repro_torch.models import transformer as tt
from repro_torch.models.convert import numpy_params, tree_from_numpy
from repro_torch.train import pytree
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.steps import make_train_step, value_and_grad

DENSE = ("granite-8b", "gemma2-27b", "deepseek-7b")
LM_IDS = DENSE + ("qwen2-moe-a2.7b", "granite-moe-3b-a800m")
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 5e-2)}
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def lm_batch(cfg, seed: int, B: int = 2) -> dict:
    return testing.lm_batch(cfg, np.random.default_rng(seed), B=B)


def jax_loss(jcfg, jdt):
    """The reference's ``train_loss`` with its forward in ``jdt``."""
    def loss(p, b):
        logits, aux = jt.forward(jcfg, p, b["tokens"], compute_dtype=jdt)
        return (jax_xent(logits, b["labels"], b["mask"])
                + jcfg.router_aux_coef * aux / max(jcfg.n_layers, 1))
    return loss


def port_value_and_grad(cfg, params, batch, dtype):
    loss_fn = partial(tt.train_loss, cfg, compute_dtype=dtype)
    loss, grads = value_and_grad(loss_fn)(
        tree_from_numpy(params, device="cpu"),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    return float(loss), pytree.flatten_with_paths(grads)


def hold_loss_and_grads(cfg, jcfg, dtype) -> list:
    """The port's loss and gradient against the reference's on numpy
    seed 0's tree and seed 1's batch: the loss and every leaf (in jax's
    order, by its path) within ``DTYPES[dtype]``'s tolerance; returns
    the port's ``[(path, gradient)]``."""
    tdt, jdt, tol = DTYPES[dtype]
    params, batch = numpy_params(cfg, seed=0), lm_batch(cfg, seed=1)
    jl, jg = jax.jit(jax.value_and_grad(jax_loss(jcfg, jdt)))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch))
    loss, grads = port_value_and_grad(cfg, params, batch, tdt)
    assert loss == pytest.approx(float(jl), rel=tol)
    want = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert [p for p, _ in grads] == [jax.tree_util.keystr(p)
                                     for p, _ in want]
    errs = {p: rel_l2(g.float().numpy(), w)
            for (p, g), (_, w) in zip(grads, want)}
    assert max(errs.values()) <= tol, errs
    return grads


def hold_three_steps(arch):
    """Three f32 steps, batch 4 in two microbatches, against the
    reference's jitted step: each step's loss and gradient norm, then
    every parameter and moment."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke(arch)
    params = numpy_params(cfg, seed=4)
    batches = [lm_batch(cfg, seed=10 + s, B=4) for s in range(3)]
    jstep = jax.jit(js.make_train_step(jax_loss(jcfg, jnp.float32),
                                       jo.AdamWConfig(**OPT),
                                       accum_steps=2))
    jp = jax.tree.map(jnp.asarray, params)
    jst = jo.adamw_init(jp)
    tp = tree_from_numpy(params, device="cpu")
    tst = adamw_init(tp)
    step = make_train_step(partial(tt.train_loss, cfg,
                                   compute_dtype=torch.float32),
                           AdamWConfig(**OPT), accum_steps=2)
    for b in batches:
        jp, jst, jm = jstep(jp, jst, jax.tree.map(jnp.asarray, b))
        tp, tst, tm = step(tp, tst, {k: torch.as_tensor(v)
                                     for k, v in b.items()})
        for key in ("loss", "grad_norm"):
            assert float(tm[key]) == pytest.approx(float(jm[key]),
                                                   rel=1e-5), key
    got = pytree.leaves(dict(params=tp, opt=tst))
    want = jax.tree.leaves(dict(params=jp, opt=jst))
    assert len(got) == len(want) and int(tst.step) == 3
    for a, b in zip(got, want):
        assert rel_l2(a.numpy(), b) <= 1e-5


def hold_remat_on_equals_off(arch, dtype):
    cfg = get_smoke_config(arch)
    params, batch = numpy_params(cfg, seed=2), lm_batch(cfg, seed=3)
    on = port_value_and_grad(cfg, params, batch, dtype)
    off = port_value_and_grad(dataclasses.replace(cfg, remat=False), params,
                              batch, dtype)
    assert on[0] == off[0]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(on[1], off[1]))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_reference(arch, dtype):
    cfg, jcfg = get_smoke_config(arch), jax_smoke(arch)
    assert cfg.remat and jcfg.remat
    hold_loss_and_grads(cfg, jcfg, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", DENSE)
def test_remat_on_equals_off(arch, dtype):
    hold_remat_on_equals_off(arch, dtype)


# (causal, window, softcap), (Hq, Hkv): every mask kind, G = 1, 2 and 3
CASES = [((True, 0, 0.0), (2, 2)), ((True, 5, 0.0), (4, 2)),
         ((True, 0, 50.0), (6, 2)), ((True, 9, 20.0), (6, 2)),
         ((False, 0, 0.0), (4, 2))]


def _qkvg(seed, B, S, Hq, Hkv, D):
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32)
            for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D),
                      (B, S, Hq, D))]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mask,heads", CASES)
def test_blockwise_matches_reference_attention_flash(mask, heads, dtype):
    """Forward and gradient, S = 37 in q blocks of 8 and kv blocks of 16
    (ragged tails, skipped blocks); f32 within 1e-5, bf16 within 1e-2
    (both round p to bf16 before ``p @ v``; their f32 sums differ in
    order)."""
    causal, window, cap = mask
    tdt, jdt, _ = DTYPES[dtype]
    tol = 1e-5 if dtype == "float32" else 1e-2
    q, k, v, g = _qkvg(0, 2, 37, *heads, 16)
    kw = dict(causal=causal, window=window, attn_softcap=cap, q_block=8,
              kv_block=16)

    def jf(q, k, v):
        o = ja.attention_flash(q, k, v, **kw)
        return jnp.sum(o.astype(jnp.float32) * g), o
    (_, want), jgrads = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    x = [torch.as_tensor(a).to(tdt).requires_grad_() for a in (q, k, v)]
    got = ta.attention_blockwise(*x, **kw)
    grads = torch.autograd.grad(got, x, torch.as_tensor(g).to(tdt))
    assert got.dtype == tdt
    assert rel_l2(got.float().detach().numpy(), want) <= tol
    for a, b in zip(grads, jgrads):
        assert rel_l2(a.float().numpy(), b) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask,heads", CASES[:4])
def test_flash_attention_fn_grad_matches_blockwise_autograd(mask, heads,
                                                            dtype):
    """S = 520: the Function's backward runs two q blocks (512 + 8) and
    sums their dK, dV in f32; whole-sequence autograd of
    ``attention_blockwise`` is the reference's gradient.  The forward is
    the flash wrapper's (the plain version on the CPU).  f32 within
    1e-6, bf16 within 1e-2 (dK, dV rounded once instead of per q
    block)."""
    causal, window, cap = mask
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    q, k, v, g = (torch.as_tensor(a).to(dtype)
                  for a in _qkvg(1, 1, 520, *heads, 16))
    kw = dict(causal=causal, window=window, attn_softcap=cap)
    x = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ta.FlashAttentionFn.apply(*x, causal, window, cap)
    got = torch.autograd.grad(out, x, g)
    y = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ta.attention_blockwise(*y, **kw), y, g)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert rel_l2(a.float().numpy(), b.float().numpy()) <= tol


def test_three_train_steps_match_reference():
    hold_three_steps("granite-8b")


@pytest.mark.parametrize("arch", LM_IDS)
def test_param_counts_are_the_references(arch):
    for mine, ref in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke(arch))):
        assert mine.param_count() == ref.param_count()
        assert mine.active_param_count() == ref.active_param_count()

"""Training steps of the port against the JAX package, and the
EmbeddingBag gradient.

* Three ``make_train_step`` steps (AdamW, the reference's step jitted)
  from the same numpy weights and batches: GAT on a padded full graph,
  GatedGCN on molecules, GraphSAGE on sampled blocks (f32: losses and
  gradient norms 1e-5) and DCN-v2 smoke on the reference's
  ``synthetic_batch`` (bf16 forward: 5e-2, the bf16 tolerance of
  ``test_torch_recsys.py``).
* DCN-v2 ``train_loss`` and its table gradient against
  ``jax.value_and_grad`` (f32 forward 1e-5, bf16 5e-2).
* ``recsys.embedding_bag``'s backward (one ``index_add_`` in f32, cast
  to the table's dtype) against the autograd of the plain version
  ``embedding_bag_ref`` on the f32 table (its gradient rounded once to
  the table's dtype) and against ``jax.grad`` of the reference's lookup:
  f32 1e-6, bf16 1e-2 (one bf16 rounding).  Pads, ids past the table, duplicates and weights included;
  a weight that requires a gradient is refused.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.launch.train import synthetic_batch as jax_synthetic_batch
from repro.models import gnn as jg
from repro.models import recsys as jr
from repro.train import optimizer as jo
from repro.train import steps as js
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.embedding_bag.ops import embedding_bag as kernel
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.launch.train import synthetic_batch
from repro_torch.models import recsys
from repro_torch.models.convert import (numpy_recsys_params,
                                        recsys_from_numpy, tree_from_numpy)
from repro_torch.testing import TRAIN_SMOKE, smoke_train_case, to_torch
from repro_torch.train import pytree
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.steps import make_train_step, value_and_grad

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


@pytest.mark.parametrize("name,tol", [("gat-cora", 1e-5),
                                      ("gatedgcn", 1e-5),
                                      ("graphsage-reddit-blocks", 1e-5),
                                      ("dcn-v2", 5e-2)])
def test_three_train_steps_match_reference(name, tol):
    cfg, loss_fn, params, batches = smoke_train_case(name)
    jcfg = jax_smoke(next(arch for n, arch, _ in TRAIN_SMOKE if n == name))
    assert jcfg.name == cfg.name
    jloss = (jr.train_loss if cfg.family == "recsys" else jg.train_loss)
    jstep = jax.jit(js.make_train_step(lambda p, b: jloss(jcfg, p, b),
                                       jo.AdamWConfig(**OPT)))
    jp = jax.tree.map(jnp.asarray, params)
    jst = jo.adamw_init(jp)
    tp = (recsys_from_numpy(cfg, params, device="cpu")
          if cfg.family == "recsys" else tree_from_numpy(params, device="cpu"))
    tst = adamw_init(tp)
    step = make_train_step(loss_fn, AdamWConfig(**OPT))
    for b in batches:
        jp, jst, jm = jstep(jp, jst, jax.tree.map(jnp.asarray, b))
        tp, tst, tm = step(tp, tst, to_torch(b, "cpu"))
        for k in ("loss", "grad_norm"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=tol,
                                                 abs=tol), k
    assert int(tst.step) == 3


def test_synthetic_batch_is_the_references():
    cfg, jcfg = get_smoke_config("dcn-v2"), jax_smoke("dcn-v2")
    for step in (0, 1001):
        want = jax_synthetic_batch(jcfg, 8, 0, step)
        got = synthetic_batch(cfg, 8, 0, step, "cpu")
        assert set(got) == set(want)
        for k in want:
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
            assert np.array_equal(got[k].numpy(), np.asarray(want[k]))


def _jax_f32_train_loss(jcfg, params, batch):
    """The reference's ``train_loss`` with its forward in f32."""
    logits = jr.forward(jcfg, params, batch, jnp.float32)
    y = batch["label"].astype(jnp.float32)
    return jnp.mean(jnp.maximum(logits, 0) - logits * y
                    + jnp.log1p(jnp.exp(-jnp.abs(logits))))


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 5e-2),
                                       (torch.float32, 1e-5)])
def test_recsys_train_loss_and_table_grad_match_reference(dtype, tol):
    """The loss and the table gradient; in f32 every leaf's gradient
    too."""
    cfg, jcfg = get_smoke_config("dcn-v2"), jax_smoke("dcn-v2")
    params = numpy_recsys_params(cfg, 0)
    batch = jax_synthetic_batch(jcfg, 32, 0, 5)
    jloss = (_jax_f32_train_loss if dtype == torch.float32
             else jr.train_loss)
    wl, wg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(jcfg, p, b)))(
            jax.tree.map(jnp.asarray, params), batch)
    tl, tg = value_and_grad(
        lambda p, b: recsys.train_loss(cfg, p, b, compute_dtype=dtype))(
        recsys_from_numpy(cfg, params, device="cpu"),
        synthetic_batch(cfg, 32, 0, 5, "cpu"))
    assert float(tl) == pytest.approx(float(wl), rel=tol, abs=tol)
    want = np.asarray(wg["table"])
    rows = np.abs(want).sum(1) > 0
    assert rows.sum() > 0
    got = tg["table"].numpy()
    assert np.array_equal(np.abs(got).sum(1) > 0, rows)   # rows touched
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())
    if dtype == torch.float32:
        for (path, g), w in zip(pytree.flatten_with_paths(tg),
                                jax.tree.leaves(wg)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                       atol=tol * np.abs(w).max(),
                                       err_msg=path)


def _bag_case(dtype, weighted, seed=0):
    r = np.random.default_rng(seed)
    V, d, B, bag = 40, 8, 64, 5
    table = torch.as_tensor(r.standard_normal((V, d)), dtype=dtype)
    idx = r.integers(0, V, (B, bag))
    idx[:, 0] = 3                                  # a row every bag reads
    idx[r.random((B, bag)) < 0.2] = -1             # pads
    idx[0, 1] = V + 7                              # past the table: row V-1
    w = (torch.as_tensor(r.standard_normal((B, bag)), dtype=torch.float32)
         if weighted else None)
    g = torch.as_tensor(r.standard_normal((B, d)), dtype=dtype)
    return table, torch.as_tensor(idx), w, g


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 1e-2)])
def test_embedding_bag_backward_matches_plain_autograd(dtype, tol, weighted):
    table, idx, w, g = _bag_case(dtype, weighted)
    t1 = table.clone().requires_grad_()
    before = kernel.launches
    out = recsys.embedding_bag(t1, idx, w)
    out.backward(g)
    assert kernel.launches == before                 # CPU: plain version
    t2 = table.float().requires_grad_()     # f32 sums, rounded once
    embedding_bag_ref(t2, idx, w).backward(g.float())
    assert t1.grad.dtype == dtype
    want = t2.grad.to(dtype).float()
    torch.testing.assert_close(t1.grad.float(), want, rtol=tol,
                               atol=tol * float(want.abs().max()))
    torch.testing.assert_close(out, embedding_bag_ref(table, idx, w))


@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_backward_matches_reference_grad(weighted):
    table, idx, w, g = _bag_case(torch.float32, weighted, seed=1)
    idx = idx.clamp(max=table.shape[0] - 1)  # the reference clamps ids too

    def jax_loss(tab):
        out = jr.embedding_bag(tab, jnp.asarray(idx.numpy()),
                               None if w is None else jnp.asarray(w.numpy()))
        return jnp.sum(out * jnp.asarray(g.numpy()))
    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(table.numpy())))
    t = table.clone().requires_grad_()
    (recsys.embedding_bag(t, idx, w) * g).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_embedding_bag_leading_dims_and_no_weight_gradient():
    table, idx, w, g = _bag_case(torch.float32, True)
    t = table.clone().requires_grad_()
    out = recsys.embedding_bag(t, idx.reshape(8, 8, 5), w.reshape(8, 8, 5))
    assert out.shape == (8, 8, 8)
    out.sum().backward()
    t2 = table.clone().requires_grad_()
    recsys.embedding_bag(t2, idx, w).sum().backward()
    assert torch.equal(t.grad, t2.grad)
    with pytest.raises(ValueError, match="weights"):
        recsys.embedding_bag(table, idx, w.clone().requires_grad_())
    with torch.no_grad():                            # serving: no graph
        assert not recsys.embedding_bag(t, idx, w).requires_grad

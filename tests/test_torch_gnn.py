"""The port's GNN zoo against ``repro.models.gnn`` on full graphs with pad
edges: for GAT, GatedGCN, GraphSAGE and GraphCast, ``forward``,
``train_loss`` and the gradient of every parameter against
``jax.value_and_grad`` on the same numpy weights and batch (the
reference's ``init_params`` layout, perturbed from a numpy seed so every
bias and LayerNorm weight is seen), f32, 1e-5 relative to each leaf's
largest magnitude.  Batches are the reference's cell layouts at smoke
size (``repro_torch.testing.gnn_full_batch``, edges padded to a multiple
of 16 with receiver ``n``).  The minibatch and molecule paths, the
sampler and the segment primitives are in ``test_torch_gnn_paths.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import gnn as jg
from repro_torch.configs import get_smoke_config
from repro_torch.models import gnn
from repro_torch.models.convert import tree_from_numpy, numpy_gnn_params
from repro_torch.testing import gnn_full_batch, to_torch
from repro_torch.train import pytree
from repro_torch.train.steps import value_and_grad

TOL = 1e-5
ARCHS = ("gat-cora", "gatedgcn", "graphsage-reddit", "graphcast")


def close(got, want, tol=TOL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def held(arch, batch, d_in, d_out, seed=0, jcfg=None, cfg=None):
    """Loss and every gradient of the port against the reference."""
    jcfg = jcfg or jax_smoke(arch)
    cfg = cfg or get_smoke_config(arch)
    params = numpy_gnn_params(cfg, d_in, d_out, seed)
    shapes = jax.eval_shape(lambda: jg.init_params(
        jcfg, d_in, d_out, jax.random.PRNGKey(0)))
    assert jax.tree.map(lambda s: s.shape, shapes) == \
        jax.tree.map(lambda a: a.shape, params)
    jb = jax.tree.map(jnp.asarray, batch)
    wl, wg = jax.jit(jax.value_and_grad(
        lambda p, b: jg.train_loss(jcfg, p, b)))(
            jax.tree.map(jnp.asarray, params), jb)
    tl, tg = value_and_grad(lambda p, b: gnn.train_loss(cfg, p, b))(
        tree_from_numpy(params, device="cpu"), to_torch(batch, "cpu"))
    close(float(tl), float(wl))
    flat, _ = jax.tree_util.tree_flatten_with_path(wg)
    got = pytree.flatten_with_paths(tg)
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in flat]
    for (path, g), (_, w) in zip(got, flat):
        w = np.asarray(w)
        assert np.isfinite(w).all(), path
        close(g.numpy(), w)
    return params


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    cfg = get_smoke_config(arch)
    d_out = cfg.n_vars if cfg.kind == "graphcast" else 3
    batch = gnn_full_batch(cfg, np.random.default_rng(1), 24, 60, 6, d_out,
                           multiple=16)
    params = numpy_gnn_params(cfg, 6, d_out, 2)
    jcfg = jax_smoke(arch)
    want = jax.jit(lambda p, b: jg.forward(jcfg, p, b))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        got = gnn.forward(cfg, tree_from_numpy(params, device="cpu"),
                          to_torch(batch, "cpu"))
    assert tuple(got.shape) == want.shape == (24, d_out)
    close(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch, seed):
    cfg = get_smoke_config(arch)
    d_out = cfg.n_vars if cfg.kind == "graphcast" else 3
    batch = gnn_full_batch(cfg, np.random.default_rng(seed), 24, 60, 6,
                           d_out, multiple=16)
    if cfg.kind != "graphcast":
        assert (batch["receivers"] == 24).sum() == 4      # pad edges
    held(arch, batch, 6, d_out, seed)


@pytest.mark.parametrize("remat,group", [(False, 1), (True, 2)])
@pytest.mark.parametrize("arch", ["gatedgcn", "graphcast"])
def test_remat_groups_change_nothing(arch, remat, group):
    """``torch.utils.checkpoint`` over ``remat_group`` layers gives the
    reference's loss and gradients (the reference with the same
    settings)."""
    import dataclasses
    cfg = dataclasses.replace(get_smoke_config(arch), remat=remat,
                              remat_group=group, n_layers=3)
    jcfg = dataclasses.replace(jax_smoke(arch), remat=remat,
                               remat_group=group, n_layers=3)
    d_out = cfg.n_vars if cfg.kind == "graphcast" else 3
    batch = gnn_full_batch(cfg, np.random.default_rng(3), 20, 40, 5, d_out,
                           multiple=16)
    held(arch, batch, 5, d_out, 3, jcfg=jcfg, cfg=cfg)


def test_gat_full_width_heads_and_last_layer_mean():
    """gat-cora's own config (8 heads of 8, mean over heads at the last
    layer) on a small graph."""
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config
    cfg = get_config("gat-cora")
    batch = gnn_full_batch(cfg, np.random.default_rng(4), 30, 90, 12, 7,
                           multiple=32)
    held("gat-cora", batch, 12, 7, 4, jcfg=jax_config("gat-cora"), cfg=cfg)

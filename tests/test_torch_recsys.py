"""The port's DCN-v2 against ``repro.models.recsys`` on the same weights
(the reference's ``init_params``, biases perturbed from a numpy seed so
every bias is seen) for the dcn-v2 smoke config: ``sparse_features``
bit-equal in f32 and bf16 (bags of one id, some padded), ``forward`` (f32
1e-5, bf16 5e-2) for one-hot and multi-hot batches, ``serve_retrieval``,
and ``v_total``, ``table_offsets`` and ``param_count`` of both configs.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.configs.shapes import RECSYS_SHAPES as JAX_SHAPES
from repro.models import recsys as jr
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.models import recsys as tr
from repro_torch.models.convert import (init_recsys, numpy_recsys_params,
                                        recsys_from_numpy)

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 5e-2)}
B = 16


def _setup(dtype, bag=1, pad=0.1):
    jcfg, cfg = jax_smoke("dcn-v2"), get_smoke_config("dcn-v2")
    params = jax.tree.map(np.asarray,
                          jr.init_params(jcfg, jax.random.PRNGKey(0)))
    r = np.random.default_rng(1)
    for p in params["cross"] + params["mlp"] + [params["head"]]:
        p["b"] = (p["b"] + r.normal(0, 0.1, p["b"].shape)).astype(
            np.float32)
    shape = (B, cfg.n_sparse) if bag == 1 else (B, cfg.n_sparse, bag)
    sizes = np.array(cfg.table_sizes)
    sparse = r.integers(0, sizes if bag == 1 else sizes[:, None], size=shape)
    sparse[r.random(shape) < pad] = -1
    dense = r.standard_normal((B, cfg.n_dense)).astype(np.float32)
    tdt, jdt, _ = DTYPES[dtype]
    tp = recsys_from_numpy(cfg, params, device="cpu", dtype=tdt)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    return (jcfg, cfg, jp, tp,
            dict(dense=jnp.asarray(dense), sparse=jnp.asarray(sparse)),
            dict(dense=torch.as_tensor(dense),
                 sparse=torch.as_tensor(sparse)))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sparse_features_bit_equal(dtype):
    jcfg, cfg, jp, tp, jb, tb = _setup(dtype)
    want = jr.sparse_features(jcfg, jp, jb["sparse"])
    before = embedding_bag.launches
    got = tr.sparse_features(cfg, tp, tb["sparse"])
    assert embedding_bag.launches == before           # CPU: plain version
    assert got.dtype == tp["table"].dtype
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("bag", [1, 3])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_forward_matches_reference(dtype, bag):
    jcfg, cfg, jp, tp, jb, tb = _setup(dtype, bag=bag)
    tdt, jdt, tol = DTYPES[dtype]
    want = jr.forward(jcfg, jp, jb, compute_dtype=jdt)
    got = tr.forward(cfg, tp, tb, compute_dtype=tdt)
    assert got.shape == (B,) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_serve_retrieval_matches_reference(dtype):
    jcfg, cfg, jp, tp, jb, tb = _setup(dtype)
    tdt, jdt, tol = DTYPES[dtype]
    cand = np.random.default_rng(2).integers(0, cfg.table_sizes[0], 300)
    want = jr.serve_retrieval(jcfg, jp, dict(
        dense=jb["dense"][:1], sparse=jb["sparse"][:1],
        cand_ids=jnp.asarray(cand)), compute_dtype=jdt)
    got = tr.serve_retrieval(cfg, tp, dict(
        dense=tb["dense"][:1], sparse=tb["sparse"][:1],
        cand_ids=torch.as_tensor(cand)), compute_dtype=tdt)
    assert got.shape == (300,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def test_config_values_and_shapes():
    for mine, ref in ((get_config("dcn-v2"), jax_config("dcn-v2")),
                      (get_smoke_config("dcn-v2"), jax_smoke("dcn-v2"))):
        assert mine == tr.RecsysConfig(**{
            f: getattr(ref, f) for f in mine.__dataclass_fields__})
        assert (mine.v_total, mine.d_interact, mine.param_count()) == (
            ref.v_total, ref.d_interact, ref.param_count())
        assert np.array_equal(tr.table_offsets(mine).numpy(),
                              np.asarray(jr.table_offsets(ref)))
    assert get_config("dcn-v2").v_total == 62_988_288
    assert RECSYS_SHAPES == JAX_SHAPES


def test_weight_makers_give_the_reference_layout():
    cfg = get_smoke_config("dcn-v2")
    ref = jax.eval_shape(lambda: jr.init_params(jax_smoke("dcn-v2"),
                                                jax.random.PRNGKey(0)))
    for params in (recsys_from_numpy(cfg, numpy_recsys_params(cfg, 0),
                                     device="cpu"),
                   init_recsys(cfg, seed=0, device="cpu")):
        shapes = jax.tree.map(lambda t: tuple(t.shape), params)
        assert shapes == jax.tree.map(lambda s: s.shape, ref)
    assert init_recsys(cfg, 0, device="cpu")["table"].dtype == \
        torch.bfloat16

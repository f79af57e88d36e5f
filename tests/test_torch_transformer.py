"""The port's dense LM against ``repro.models.transformer`` on the same
weights: the reference's ``init_params`` (norms perturbed from a numpy
seed, so every norm weight is seen) -> numpy -> ``lm_from_numpy``.

For the gemma2-27b, granite-8b and deepseek-7b smoke configs, in f32
(tolerance 1e-4: the two differ only in summation order, measured
~4e-6) and in bf16 (5e-2, the tolerance of ``tests/test_models_smoke``:
bf16 rounds at other places in the two frameworks): ``forward`` logits,
``prefill`` last logits, cache and ``kv_len``, then three
``decode_step``s.  The prompt (20) is longer than the smoke window (8).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import transformer as jt
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models.convert import lm_from_numpy
from repro_torch.models.transformer import (LMConfig, TransformerLM,
                                            _scalar, layer_windows)

# the dense LMs (the MoE LMs are held against the reference in
# test_torch_moe_lm.py, DCN-v2 in test_torch_recsys.py)
DENSE_IDS = ("granite-8b", "gemma2-27b", "deepseek-7b")

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-4),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 5e-2)}
S, CACHE, STEPS = 20, 24, 3


def _setup(arch):
    jcfg = jax_smoke(arch)
    params = jax.tree.map(np.asarray,
                          jt.init_params(jcfg, jax.random.PRNGKey(1)))
    r = np.random.default_rng(4)
    for k in [k for k in params["layers"] if k.endswith("norm")]:
        params["layers"][k] = (params["layers"][k] + r.normal(
            0, 0.1, params["layers"][k].shape)).astype(np.float32)
    params["final_norm"] = (params["final_norm"] + r.normal(
        0, 0.1, params["final_norm"].shape)).astype(np.float32)
    model = lm_from_numpy(get_smoke_config(arch), params, device="cpu")
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab,
                                               (2, S + STEPS))
    return jcfg, jax.tree.map(jnp.asarray, params), model, tokens


def _close(got, want, dtype, what):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", DENSE_IDS)
def test_forward_matches_reference(arch, dtype):
    jcfg, jp, model, tokens = _setup(arch)
    tdt, jdt, _ = DTYPES[dtype]
    want, _ = jt.forward(jcfg, jp, jnp.asarray(tokens[:, :S]),
                         compute_dtype=jdt)
    got, aux = model.forward(torch.as_tensor(tokens[:, :S]),
                             compute_dtype=tdt)
    assert got.shape == (2, S, jcfg.vocab) and float(aux) == 0.0
    _close(got, want, dtype, "forward logits")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", DENSE_IDS)
def test_prefill_and_decode_match_reference(arch, dtype):
    jcfg, jp, model, tokens = _setup(arch)
    tdt, jdt, _ = DTYPES[dtype]
    want, jcache = jt.prefill(jcfg, jp, jnp.asarray(tokens[:, :S]), CACHE,
                              compute_dtype=jdt)
    got, cache = model.prefill(torch.as_tensor(tokens[:, :S]), CACHE,
                               compute_dtype=tdt)
    assert got.shape == (2, 1, jcfg.vocab)
    assert cache["k"].shape == jcache["k"].shape
    assert cache["kv_len"] == int(jcache["kv_len"]) == S
    _close(got, want, dtype, "prefill logits")
    for name in ("k", "v"):
        _close(cache[name], jcache[name], dtype, f"prefill cache {name}")
    for step in range(STEPS):
        tok = tokens[:, S + step:S + step + 1]
        want, jcache = jt.decode_step(jcfg, jp, jcache, jnp.asarray(tok),
                                      compute_dtype=jdt)
        got, cache = model.decode_step(cache, torch.as_tensor(tok),
                                       compute_dtype=tdt)
        assert cache["kv_len"] == int(jcache["kv_len"]) == S + step + 1
        _close(got, want, dtype, f"decode {step} logits")
        for name in ("k", "v"):
            _close(cache[name], jcache[name], dtype,
                   f"decode {step} cache {name}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_are_the_reference_values(arch):
    for mine, ref in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke(arch))):
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        assert [f.name for f in dataclasses.fields(mine)] == \
            [f.name for f in dataclasses.fields(ref)]
        if mine.family == "lm":
            assert mine.hd == ref.hd
        elif mine.family == "recsys":
            assert mine.param_count() == ref.param_count()


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "granite-moe-3b-a800m"])
def test_moe_configs_are_not_ported_yet(arch):
    """The MoE configs are ported now (the name is kept from the slice
    that refused them): the registry gives the reference's values, and an
    unknown id still raises."""
    for mine, ref in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke(arch))):
        assert mine.is_moe and dataclasses.asdict(mine) == \
            dataclasses.asdict(ref)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


def test_model_refuses_moe_and_sharded_residuals():
    """Sharded residuals are still refused; an MoE config builds (it was
    refused before MoE was ported; the name is kept)."""
    base = dict(name="x", n_layers=2, d_model=8, n_heads=2, n_kv_heads=1,
                d_ff=8, vocab=4)
    with pytest.raises(NotImplementedError, match="not ported"):
        TransformerLM(LMConfig(**base, residual_spec=("data", None, None)),
                      torch.zeros(4, 8), torch.zeros(8), [{}, {}],
                      torch.zeros(8, 4))
    moe = TransformerLM(LMConfig(**base, n_experts=4, top_k=1, d_expert=8),
                        torch.zeros(4, 8), torch.zeros(8), [{}, {}],
                        torch.zeros(8, 4))
    assert moe.cfg.is_moe


def test_gemma2_layers_alternate_local_then_global():
    cfg = get_config("gemma2-27b")
    w = layer_windows(cfg)
    assert len(w) == 46 and w[0::2] == (4096,) * 23 and w[1::2] == (0,) * 23
    assert set(layer_windows(get_config("granite-8b"))) == {0}


def test_scalars_round_to_bf16_as_jax_weak_types_do():
    """Gemma-2-27B's embedding scale sqrt(4608) is 68.0 in bf16 and its
    query pre-scale sqrt(128) / 12 is 0.94140625; the port multiplies
    by those rounded values, bit for bit as the reference does."""
    cfg = get_config("gemma2-27b")
    r = np.random.default_rng(6)
    x = r.standard_normal((4, 257)).astype(np.float32)
    tx, jx = torch.as_tensor(x).bfloat16(), jnp.asarray(x, jnp.bfloat16)
    emb = cfg.d_model ** 0.5
    assert _scalar(emb, tx).item() == 68.0
    got = tx * _scalar(emb, tx)
    want = jx * jnp.asarray(emb, jnp.bfloat16)        # transformer.py:275
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))
    pre = cfg.query_scale * cfg.hd ** 0.5
    assert _scalar(pre, tx).item() == 0.94140625
    got = tx * _scalar(pre, tx)
    want = jx * pre                                   # transformer.py:208
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))
    # a plain torch scalar would not round first, and would differ
    assert not torch.equal(tx * pre, got)

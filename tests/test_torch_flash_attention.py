"""The port's flash attention (the plain version its wrapper runs on CPU
tensors) against the JAX package: the Pallas kernel in interpret mode
and its materialised oracle, on the kernel tests' cases; and the
wrapper's refusals."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as pallas_fa
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from test_kernels import FA_CASES

DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _inputs(B, Sq, Skv, Hq, Hkv, D, seed, dtype):
    """q, k, v from a numpy seed, as (torch, jax) pairs of one dtype:
    both frameworks round the same f32 values to bf16 identically."""
    tdt, jdt, _ = DTYPES[dtype]
    r = np.random.default_rng(seed)
    arrs = [r.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]
    return ([torch.as_tensor(a).to(tdt) for a in arrs],
            [jnp.asarray(a, jdt) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", FA_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_matches_pallas_kernel_and_oracle(case, dtype):
    B, Sq, Skv, Hq, Hkv, D, causal, window, cap = case
    (tq, tk, tv), (jq, jk, jv) = _inputs(B, Sq, Skv, Hq, Hkv, D,
                                         FA_CASES.index(case), dtype)
    kw = dict(causal=causal, window=window, attn_softcap=cap)
    got = flash_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == (B, Sq, Hq, D)
    tol = DTYPES[dtype][2]
    for want in (pallas_fa(jq, jk, jv, bq=128, bk=128, interpret=True, **kw),
                 attention_ref(jq, jk, jv, **kw)):
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", [
    # (B, Sq, Skv, Hq, Hkv, D, causal, window, softcap): no tile multiples
    (1, 200, 200, 4, 2, 32, True, 48, 50.0),
    (2, 70, 130, 2, 1, 16, False, 0, 0.0),
    (1, 93, 93, 8, 8, 64, True, 0, 30.0),
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ragged_lengths_match_oracle(case, dtype):
    """The Pallas kernel needs tile multiples; its oracle does not."""
    B, Sq, Skv, Hq, Hkv, D, causal, window, cap = case
    (tq, tk, tv), (jq, jk, jv) = _inputs(B, Sq, Skv, Hq, Hkv, D, 7, dtype)
    kw = dict(causal=causal, window=window, attn_softcap=cap)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np(flash_attention(tq, tk, tv, **kw)),
                               _np(attention_ref(jq, jk, jv, **kw)),
                               atol=tol, rtol=tol)


def _qkv(B=1, Sq=16, Skv=16, Hq=4, Hkv=2, D=32, dtype=torch.float32,
         device="cpu"):
    return (torch.zeros((B, Sq, Hq, D), dtype=dtype, device=device),
            torch.zeros((B, Skv, Hkv, D), dtype=dtype, device=device),
            torch.zeros((B, Skv, Hkv, D), dtype=dtype, device=device))


@pytest.mark.parametrize("bad,match", [
    (dict(dtype=torch.float16), "float32 / bfloat16"),
    (dict(D=48), "head dim 48"),
    (dict(Hq=3), "not a multiple"),
    (dict(device="meta"), "no kernel for device"),
])
def test_wrapper_refuses(bad, match):
    before = flash_attention.launches
    with pytest.raises(ValueError, match=match):
        flash_attention(*_qkv(**bad))
    assert flash_attention.launches == before


def test_wrapper_refuses_shapes_and_mixtures():
    q, k, v = _qkv()
    with pytest.raises(ValueError, match="must be"):
        flash_attention(q[0], k, v)
    with pytest.raises(ValueError, match="must be"):
        flash_attention(q, k, v[:, :8])
    with pytest.raises(ValueError, match="batch or head dim"):
        flash_attention(q, k[:, :, :, :16], v[:, :, :, :16])
    with pytest.raises(ValueError, match="share one dtype"):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="different devices"):
        flash_attention(q, k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="no key in their window"):
        flash_attention(*_qkv(Sq=40, Skv=16), window=8)
    with pytest.raises(ValueError, match="no keys"):
        flash_attention(*_qkv(Skv=0))


def test_cpu_path_launches_nothing():
    before = flash_attention.launches
    out = flash_attention(*_qkv(), window=4, attn_softcap=50.0)
    assert out.shape == (1, 16, 4, 32)
    assert flash_attention.launches == before

"""The port's attention paths against ``repro.models.attention``: the
naive reference with explicit positions and ``kv_len``, decode against a
cache (scalar and per-batch ``kv_len``, windows, softcap), and the
``impl`` dispatch."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ja
from repro_torch.models import attention as ta

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _arrs(seed, *shapes):
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("window,cap", [(0, 0.0), (5, 50.0)])
def test_naive_with_positions_and_kv_len(dtype, window, cap):
    q, k, v = _arrs(0, (2, 6, 4, 16), (2, 11, 2, 16), (2, 11, 2, 16))
    qpos, kpos = np.arange(5, 11), np.arange(11)
    kw = dict(causal=True, window=window, attn_softcap=cap)
    got = ta.attention_naive(*(torch.as_tensor(a).to(TDT[dtype])
                               for a in (q, k, v)),
                             q_positions=torch.as_tensor(qpos),
                             kv_positions=torch.as_tensor(kpos),
                             kv_len=9, **kw)
    want = ja.attention_naive(*(jnp.asarray(a, JDT[dtype])
                                for a in (q, k, v)),
                              q_positions=jnp.asarray(qpos),
                              kv_positions=jnp.asarray(kpos), kv_len=9, **kw)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("kv_len", [1, 7, [4, 12]])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (3, 50.0)])
def test_decode(dtype, kv_len, window, cap):
    q, kc, vc = _arrs(1, (2, 1, 4, 16), (2, 12, 2, 16), (2, 12, 2, 16))
    kw = dict(window=window, attn_softcap=cap)
    got = ta.attention_decode(*(torch.as_tensor(a).to(TDT[dtype])
                                for a in (q, kc, vc)),
                              kv_len=torch.as_tensor(kv_len), **kw)
    want = ja.attention_decode(*(jnp.asarray(a, JDT[dtype])
                                 for a in (q, kc, vc)),
                               kv_len=jnp.asarray(kv_len), **kw)
    _close(got, want, dtype)


@pytest.mark.parametrize("kv_len", [1, 7, 12])
def test_decode_int_and_tensor_kv_len_agree(kv_len):
    q, kc, vc = (torch.as_tensor(a) for a in
                 _arrs(4, (2, 1, 4, 16), (2, 12, 2, 16), (2, 12, 2, 16)))
    kw = dict(window=3, attn_softcap=50.0)
    a = ta.attention_decode(q, kc, vc, kv_len=kv_len, **kw)
    b = ta.attention_decode(q, kc, vc, kv_len=torch.tensor(kv_len), **kw)
    assert torch.equal(a, b)


def test_decode_on_the_visible_slice_equals_the_whole_cache():
    """What ``decode_step`` relies on: attending to slots
    ``[kv_len - window, kv_len)`` only is the full masked result."""
    q, kc, vc = (torch.as_tensor(a) for a in
                 _arrs(2, (2, 1, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16)))
    full = ta.attention_decode(q, kc, vc, kv_len=30, window=8,
                               attn_softcap=50.0)
    part = ta.attention_decode(q, kc[:, 22:30], vc[:, 22:30], kv_len=8,
                               window=8, attn_softcap=50.0)
    torch.testing.assert_close(part, full, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("impl", ["naive", "flash", "pallas"])
def test_dispatch_matches_reference_flash(impl):
    q, k, v = _arrs(3, (1, 24, 4, 16), (1, 24, 2, 16), (1, 24, 2, 16))
    kw = dict(causal=True, window=6, attn_softcap=30.0)
    got = ta.attention(*(torch.as_tensor(a) for a in (q, k, v)), impl=impl,
                       **kw)
    want = ja.attention_flash(*(jnp.asarray(a) for a in (q, k, v)),
                              q_block=8, kv_block=8, **kw)
    _close(got, want, "float32")
    with pytest.raises(ValueError, match="unknown attention impl"):
        ta.attention(*(torch.as_tensor(a) for a in (q, k, v)), impl="x")

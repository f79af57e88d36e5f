"""The port's flash attention (the plain version its wrapper runs on CPU
tensors) against the JAX package: the Pallas kernel in interpret mode
and its materialised oracle, on the kernel tests' cases; the plain
version's ``round_p=True`` trajectory (the sm90 kernel's) against the
LM's blockwise JAX attention; the wrapper's dispatch and refusals."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as pallas_fa
from repro.kernels.flash_attention.ref import attention_ref
from repro.models.attention import attention_flash
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     kernel_for, tma_ready)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
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


RAGGED_CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, causal, window, softcap): no tile multiples
    (1, 200, 200, 4, 2, 32, True, 48, 50.0),
    (2, 70, 130, 2, 1, 16, False, 0, 0.0),
    (1, 93, 93, 8, 8, 64, True, 0, 30.0),
]


@pytest.mark.parametrize("case", RAGGED_CASES)
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


# round_p=True against repro.models.attention.attention_flash with
# kv_block = kv_tile: the same tiles, running max and bf16 rounding of p.
# f32: the two differ only in the order of f32 sums and in exp's last bit
# (measured <= 8e-7).  bf16: the p the two round are equal but for f32
# near-ties, so an output element is equal, one bf16 ulp apart (2^-7
# relative at most), or moved by one p rounded the other way (2^-8 p |v|
# / l, measured <= 1.9e-4 absolute); the whole output agrees to relative
# L2 <= 2e-4 (measured <= 6e-5).  The default plain version, which keeps
# p in f32, sits ~2e-3 away, so these limits tell the two trajectories
# apart.
ROUND_TOL = {"float32": dict(atol=1e-5, rtol=1e-5, rel_l2=1e-6),
             "bfloat16": dict(atol=2.0 ** -10, rtol=2.0 ** -7, rel_l2=2e-4)}
ROUND_CASES = FA_CASES + RAGGED_CASES + [
    (1, 333, 333, 4, 1, 64, True, 100, 50.0),   # GQA 4:1, ragged window
    (2, 129, 257, 2, 2, 64, False, 0, 0.0),     # one key past a tile
]


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("kv_tile", [128, 64])
@pytest.mark.parametrize("case", ROUND_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rounded_plain_version_matches_jax_blockwise(case, dtype, kv_tile):
    B, Sq, Skv, Hq, Hkv, D, causal, window, cap = case
    (tq, tk, tv), (jq, jk, jv) = _inputs(B, Sq, Skv, Hq, Hkv, D,
                                         ROUND_CASES.index(case), dtype)
    kw = dict(causal=causal, window=window, attn_softcap=cap)
    got = flash_attention_ref(tq, tk, tv, round_p=True, kv_tile=kv_tile,
                              **kw)
    assert got.dtype == tq.dtype and got.shape == (B, Sq, Hq, D)
    want = _np(attention_flash(jq, jk, jv, kv_block=kv_tile, **kw))
    tol = ROUND_TOL[dtype]
    np.testing.assert_allclose(_np(got), want, atol=tol["atol"],
                               rtol=tol["rtol"])
    assert _rel_l2(_np(got), want) <= tol["rel_l2"]


@pytest.mark.parametrize("case", ROUND_CASES[:3] + RAGGED_CASES[:1])
def test_rounding_p_moves_bf16_by_one_rounding(case):
    """In bf16 the rounded trajectory sits one bf16 rounding of p from
    the default plain version (relative L2 between 5e-4 and 5e-3); in
    f32 rounding p to f32 changes nothing but the order of sums."""
    B, Sq, Skv, Hq, Hkv, D, causal, window, cap = case
    kw = dict(causal=causal, window=window, attn_softcap=cap)
    for dtype, lo, hi in (("bfloat16", 5e-4, 5e-3), ("float32", 0.0, 1e-6)):
        (q, k, v), _ = _inputs(B, Sq, Skv, Hq, Hkv, D, 11, dtype)
        base = _np(flash_attention_ref(q, k, v, **kw))
        moved = _rel_l2(_np(flash_attention_ref(q, k, v, round_p=True,
                                                **kw)), base)
        assert lo <= moved <= hi, (dtype, moved)


def test_p_rounding_allowance_is_one_bf16_step_of_the_largest_term():
    """Two keys of equal score: p / l = 1/2 for both, so two flips move
    an output by at most 2 * 2^-7 * 1/2 * max |v|; a flat softmax over
    1024 keys allows 1/1024 of that."""
    from repro_torch.testing import p_rounding_allowance
    q = torch.zeros((1, 1, 1, 2))
    k = torch.zeros((1, 2, 1, 2))
    v = torch.tensor([[[[1.0, -3.0]], [[2.0, 0.5]]]])
    got = p_rounding_allowance(q, k, v, causal=False)
    torch.testing.assert_close(got, 2.0 ** -7 * torch.tensor(
        [[[[2.0, 3.0]]]]))
    q, k, v = (torch.zeros((1, 1024, 2, 16)) for _ in range(3))
    v[:, 7] = 1.0
    got = p_rounding_allowance(q[:, -1:], k, v, causal=False)
    torch.testing.assert_close(got, torch.full((1, 1, 2, 16),
                                               2 * 2.0 ** -7 / 1024))


@pytest.mark.parametrize("dtype,D,kernel", [
    (torch.bfloat16, 64, "flash_attention_sm90"),
    (torch.bfloat16, 128, "flash_attention_sm90"),
    (torch.bfloat16, 16, "flash_attention"),
    (torch.bfloat16, 32, "flash_attention"),
    (torch.bfloat16, 256, "flash_attention"),
    (torch.float32, 64, "flash_attention"),
    (torch.float32, 128, "flash_attention"),
])
def test_dispatch_on_dtype_and_head_dim(dtype, D, kernel):
    assert kernel_for(dtype, D) == kernel


def test_tma_ready_needs_aligned_base_and_strides():
    x = torch.zeros((2, 40, 4, 64), dtype=torch.bfloat16)
    assert tma_ready(x)
    assert tma_ready(x[:, 3:])                  # offset 3 * 256 elements
    assert tma_ready(x[:, :, 1:3])              # offset 64 elements
    assert not tma_ready(x.view(-1)[1:1 + x.numel() // 2]
                         .view(1, 40, 4, 64))   # base off by 2 bytes
    assert not tma_ready(x.transpose(1, 3))     # D not contiguous
    y = torch.zeros((2, 40, 4, 68), dtype=torch.bfloat16)[..., :64]
    assert not tma_ready(y)                     # 136-byte head stride
    assert not tma_ready(x.expand(2, 40, 4, 64).as_strided(
        (2, 40, 4, 64), (0, 256, 64, 1)))       # a zero batch stride


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

"""The port's grouped GEMM (the plain version its wrapper runs on CPU
tensors) against the JAX package: the Pallas kernel in interpret mode
and its jnp oracle, on the kernel tests' cases, a ``bm`` that is no
multiple of 8 rows of a tile, and the MoE layout (one ``C``-row block per
expert, ``block_groups = arange(G)``); ``pad_segments`` against the
reference's, array for array; the wrapper's refusals; and, without a
card, which of the two CUDA kernels a call would launch (``kernel_for``,
``tma_ready``).

Tolerances are those of ``tests/test_kernels.py``: f32 1e-4, bf16 3e-2.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_matmul.ops import pad_segments as jax_pad
from repro.kernels.segment_matmul.ops import segment_matmul as pallas_sm
from repro.kernels.segment_matmul.ref import segment_matmul_ref
from repro_torch.kernels.segment_matmul.ops import (_segment_matmul_simt,
                                                    kernel_for,
                                                    pad_segments,
                                                    segment_matmul,
                                                    tma_ready)
from test_kernels import SM_CASES

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-4),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 3e-2)}
CASES = [
    *SM_CASES,
    # (group sizes, K, N, bm, bn): bm 24, ragged K and N tails
    ((30, 0, 50, 7), 40, 72, 24, 72),
    # the MoE layout: G experts of C = 24 rows each, K / N as d / d_expert
    ((24, 24, 24, 24, 24, 24, 24, 24), 64, 96, 24, 96),
]


def _inputs(case, dtype, seed):
    sizes, K, N, bm, _ = case
    r = np.random.default_rng(seed)
    x = r.standard_normal((sum(sizes), K)).astype(np.float32)
    w = r.standard_normal((len(sizes), K, N)).astype(np.float32)
    xp, groups, row_index = pad_segments(x, np.array(sizes), bm=bm)
    tdt, jdt, _ = DTYPES[dtype]
    return ((torch.as_tensor(xp).to(tdt), torch.as_tensor(w).to(tdt),
             torch.as_tensor(groups)),
            (jnp.asarray(xp, jdt), jnp.asarray(w, jdt), jnp.asarray(groups)),
            row_index)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_matches_pallas_kernel_and_oracle(case, dtype):
    (tx, tw, tg), (jx, jw, jg), _ = _inputs(case, dtype, CASES.index(case))
    before = segment_matmul.launches
    got = segment_matmul(tx, tw, tg)
    assert segment_matmul.launches == before          # CPU: plain version
    assert got.dtype == tx.dtype and got.shape == (tx.shape[0], tw.shape[2])
    tol = DTYPES[dtype][2]
    bn = case[4]
    for want in (pallas_sm(jx, jw, jg, bn=bn, interpret=True),
                 segment_matmul_ref(jx, jw, jg)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("case", CASES)
def test_pad_segments_equals_reference(case):
    sizes, K, _, bm, _ = case
    x = np.random.default_rng(1).standard_normal((sum(sizes), K))
    for mine, ref in zip(pad_segments(x, np.array(sizes), bm),
                         jax_pad(x, np.array(sizes), bm)):
        assert mine.dtype == ref.dtype and np.array_equal(mine, ref)


def test_moe_layout_takes_the_batched_path_and_equals_the_block_loop():
    """block_groups = arange(G) (one bmm) and a permuted order (the
    per-block loop) give the same rows."""
    r = np.random.default_rng(2)
    x = torch.as_tensor(r.standard_normal((4 * 8, 16)), dtype=torch.float32)
    w = torch.as_tensor(r.standard_normal((4, 16, 12)), dtype=torch.float32)
    y = segment_matmul(x, w, torch.arange(4, dtype=torch.int32))
    perm = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    yp = segment_matmul(x, w, perm)
    for i in range(4):
        rows = slice(8 * i, 8 * i + 8)
        torch.testing.assert_close(y[rows], x[rows] @ w[i])
        torch.testing.assert_close(yp[rows], x[rows] @ w[int(perm[i])])


@pytest.mark.parametrize("bad,match", [
    (dict(x=torch.zeros(9, 4)), "blocks of equal size"),
    (dict(w=torch.zeros(2, 5, 3)), "K = 4"),
    (dict(x=torch.zeros(8, 4, dtype=torch.float16)), "float32 / bfloat16"),
    (dict(w=torch.zeros(2, 4, 3, dtype=torch.bfloat16)), "share one dtype"),
    (dict(g=torch.tensor([0, 2], dtype=torch.int32)), r"outside \[0, 2\)"),
    (dict(g=torch.tensor([0.0, 1.0])), "int32 or int64"),
    (dict(x=torch.zeros(8, 4, device="meta"),
          w=torch.zeros(2, 4, 3, device="meta")), "no kernel for device"),
    (dict(w=torch.zeros(2, 4, 3, device="meta")), "different devices"),
])
def test_wrapper_refuses(bad, match):
    args = dict(x=torch.zeros(8, 4), w=torch.zeros(2, 4, 3),
                g=torch.tensor([0, 1], dtype=torch.int32))
    args.update(bad)
    before = segment_matmul.launches
    with pytest.raises(ValueError, match=match):
        segment_matmul(args["x"], args["w"], args["g"])
    assert segment_matmul.launches == before


def _counts():
    return (segment_matmul.launches, segment_matmul.launches_sm90,
            segment_matmul.launches_simt)


@pytest.mark.parametrize("dtype,K,N,kernel", [
    # bf16 with K and N positive multiples of 8: the wgmma kernel (the MoE
    # expert products of Qwen1.5-MoE-A2.7B, both directions, and small)
    (torch.bfloat16, 2048, 1408, "segment_matmul_sm90"),
    (torch.bfloat16, 1408, 2048, "segment_matmul_sm90"),
    (torch.bfloat16, 40, 72, "segment_matmul_sm90"),
    (torch.bfloat16, 8, 8, "segment_matmul_sm90"),
    # f32: the CUDA-core kernel, whatever the widths
    (torch.float32, 2048, 1408, "segment_matmul"),
    (torch.float32, 36, 100, "segment_matmul"),
    # bf16 with a width TMA cannot stride, or no K: the mma.sync kernel
    (torch.bfloat16, 36, 128, "segment_matmul"),
    (torch.bfloat16, 64, 100, "segment_matmul"),
    (torch.bfloat16, 130, 72, "segment_matmul"),
    (torch.bfloat16, 0, 8, "segment_matmul"),
])
def test_kernel_for_choice(dtype, K, N, kernel):
    assert kernel_for(dtype, K, N) == kernel


def test_tma_ready_views():
    """Aligned contiguous rows are read in place; a base off 16 bytes, a
    strided last dimension or a row stride that is no multiple of 16
    bytes is copied first."""
    x = torch.zeros(32, 64, dtype=torch.bfloat16)
    assert tma_ready(x) and tma_ready(x[8:])
    assert not tma_ready(x.view(-1)[1:1 + 31 * 64].view(31, 64))
    assert not tma_ready(x.t())
    assert not tma_ready(torch.zeros(32, 68, dtype=torch.bfloat16)[:, :64])
    w = torch.zeros(4, 64, 128, dtype=torch.bfloat16)
    assert tma_ready(w) and not tma_ready(w.transpose(1, 2))


@pytest.mark.parametrize("case", [
    # (group sizes, K, N, bm, bn): shapes the sm90 kernel would take on
    # the card: ragged segments of two row tiles, and a decode-like layout
    ((200, 200, 200, 200), 64, 128, 200, 128),
    ((8,) * 8, 128, 256, 8, 128),
])
def test_cpu_bf16_takes_the_plain_version(case):
    """On CPU tensors, bf16 inputs the sm90 kernel would take still give
    the plain version (no counter moves), equal to the Pallas kernel in
    interpret mode."""
    (tx, tw, tg), (jx, jw, jg), _ = _inputs(case, "bfloat16", 5)
    assert kernel_for(tx.dtype, tx.shape[1], tw.shape[2]) == \
        "segment_matmul_sm90"
    before = _counts()
    got = segment_matmul(tx, tw, tg)
    assert _counts() == before
    want = pallas_sm(jx, jw, jg, bn=case[4], interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=DTYPES["bfloat16"][2],
                               rtol=DTYPES["bfloat16"][2])


def test_simt_timing_entry_needs_the_card():
    """``_segment_matmul_simt`` launches a kernel or raises: on CPU
    tensors it raises and counts nothing."""
    x, w = torch.zeros(8, 8), torch.zeros(1, 8, 8)
    before = _counts()
    with pytest.raises(ValueError, match="no kernel for device"):
        _segment_matmul_simt(x, w, torch.zeros(1, dtype=torch.int32))
    assert _counts() == before

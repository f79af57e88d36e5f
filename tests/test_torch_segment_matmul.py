"""The port's grouped GEMM (the plain version its wrapper runs on CPU
tensors) against the JAX package: the Pallas kernel in interpret mode
and its jnp oracle, on the kernel tests' cases, a ``bm`` that is no
multiple of 8 rows of a tile, and the MoE layout (one ``C``-row block per
expert, ``block_groups = arange(G)``); ``pad_segments`` against the
reference's, array for array; and the wrapper's refusals.

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
from repro_torch.kernels.segment_matmul.ops import (pad_segments,
                                                    segment_matmul)
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

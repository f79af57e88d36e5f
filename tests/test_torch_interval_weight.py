"""The interval-weight op (the plain version the wrapper runs on CPU
tensors) against the JAX package: its exact int64 oracle and its Pallas
kernel in interpret mode."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.weights  # noqa: F401  (turns on jax x64, as the reference runs)
from repro.kernels.interval_weight.ops import interval_weight as pallas_iw
from repro.kernels.interval_weight.ref import interval_weight_ref as jax_ref
from repro_torch.kernels.interval_weight.ops import interval_weight
from test_kernels import IW_CASES


def _inputs(m: int, nseg: int, Q: int, seed: int, wmax: int):
    """Segmented sorted times, integer prefix sums, random queries (the
    construction of ``tests/test_kernels.py``, with integer weights)."""
    r = np.random.default_rng(seed)
    seg_of = np.sort(r.integers(0, nseg, m))
    t_in = np.sort(r.integers(0, 10_000, m))
    csr_t = t_in[np.lexsort((t_in, seg_of))]
    ptr = np.searchsorted(seg_of, np.arange(nseg + 1))
    for s in range(nseg):
        csr_t[ptr[s]:ptr[s + 1]] = np.sort(csr_t[ptr[s]:ptr[s + 1]])
    ps_own = np.concatenate([[0], np.cumsum(r.integers(0, wmax, m))])
    ps_prev = np.concatenate([[0], np.cumsum(r.integers(0, wmax, m))])
    qs = r.integers(0, nseg, Q)
    tlo = r.integers(0, 10_000, Q)
    return [a.astype(np.int64) for a in
            (csr_t, ps_own, ps_prev, ptr[qs], ptr[qs + 1], tlo,
             tlo + r.integers(0, 3_000, Q), r.integers(0, 10_000, Q))]


def _port(args):
    return interval_weight(*(torch.as_tensor(a) for a in args)).numpy()


@pytest.mark.parametrize("case", IW_CASES)
def test_plain_op_equals_int64_oracle(case):
    """Weights far past 2^24 (as real graphs have): exact in int64."""
    args = _inputs(*case, seed=2, wmax=2 ** 40)
    want = np.asarray(jax_ref(*(jnp.asarray(a) for a in args)))
    got = _port(args)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert want.max() > 2 ** 24


@pytest.mark.parametrize("case", IW_CASES)
def test_plain_op_equals_pallas_kernel_interpret(case):
    """On ``IW_CASES`` inputs inside f32's integer range the Pallas
    kernel (interpret mode, int32 times, f32 prefixes) is exact, and the
    port matches it bit for bit."""
    m = case[0]
    args = _inputs(*case, seed=2, wmax=max(2, 2 ** 23 // m))
    assert args[1][-1] < 2 ** 24 and args[2][-1] < 2 ** 24
    jargs = ([jnp.asarray(args[0], jnp.int32)]
             + [jnp.asarray(a, jnp.float32) for a in args[1:3]]
             + [jnp.asarray(a, jnp.int32) for a in args[3:]])
    want = np.asarray(pallas_iw(*jargs, bq=256, interpret=True))
    assert np.array_equal(_port(args), want.astype(np.int64))


def test_empty_query_batch():
    args = _inputs(64, 4, 10, 1, 10)
    args[3:] = [a[:0] for a in args[3:]]
    assert _port(args).shape == (0,)

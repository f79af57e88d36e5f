"""The port's threefry RNG against ``jax.random``, bit for bit, in both
threefry modes (jax's default partitionable one and the legacy one)."""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.weights  # noqa: F401  (turns on jax x64, as the reference runs)
from repro.kernels.tree_sampler.kernel import randint_from_bits as jax_rfb
from repro_torch.core import rng

MODES = [True, False]
SEEDS = [0, 7, 2 ** 40 + 3, -5]
# spans of 1, below 2^32, just past 2^32 and near 2^62
SPANS = [1, 2, 1000, 2 ** 31 - 1, 2 ** 32 - 5, 2 ** 32, 2 ** 32 + 1,
         2 ** 40 + 7, 2 ** 62 - 3, 2 ** 62 + 11]


@contextlib.contextmanager
def threefry_mode(partitionable: bool):
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", partitionable)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", old)


def _np(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.int64) if a.dtype == np.uint64 else a.astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    want = _np(jax.random.key_data(jax.random.PRNGKey(seed)))
    assert np.array_equal(rng.PRNGKey(seed).numpy(), want)


@pytest.mark.parametrize("part", MODES)
@pytest.mark.parametrize("seed", SEEDS)
def test_split_fold_in_bits(part, seed):
    with threefry_mode(part):
        jk = jax.random.PRNGKey(seed)
        tk = rng.PRNGKey(seed)
        for num in (2, 7):
            assert np.array_equal(rng.split(tk, num, partitionable=part)
                                  .numpy(), _np(jax.random.split(jk, num)))
        for data in (0, 1, 12345, 2 ** 31 + 9):
            assert np.array_equal(rng.fold_in(tk, data).numpy(),
                                  _np(jax.random.fold_in(jk, data)))
        for K in (1, 33, 256):
            assert np.array_equal(
                rng.bits(tk, K, partitionable=part).numpy(),
                _np(jax.random.bits(jk, (K,), jnp.uint64)))


@pytest.mark.parametrize("part", MODES)
def test_batched_keys_match_per_key_calls(part):
    """A ``[n, 2]`` stack of keys gives the rows of n separate calls, as
    the engine's window keys and the sampler's child draws rely on."""
    with threefry_mode(part):
        base = jax.random.PRNGKey(11)
        tkeys = rng.fold_in(rng.PRNGKey(11), torch.arange(5))
        for j in range(5):
            jk = jax.random.fold_in(base, j)
            assert np.array_equal(tkeys[j].numpy(), _np(jk))
        got = rng.bits(rng.split(tkeys, 2, partitionable=part), 40,
                       partitionable=part)              # [5, 2, 40]
        for j in range(5):
            k1, k2 = jax.random.split(jax.random.fold_in(base, j))
            assert np.array_equal(got[j, 0].numpy(), _np(
                jax.random.bits(k1, (40,), jnp.uint64)))
            assert np.array_equal(got[j, 1].numpy(), _np(
                jax.random.bits(k2, (40,), jnp.uint64)))


@pytest.mark.parametrize("part", MODES)
@pytest.mark.parametrize("span", SPANS)
def test_randint_scalar_span(part, span):
    with threefry_mode(part):
        for seed in (0, 3):
            want = jax.random.randint(jax.random.PRNGKey(seed), (64,), 0,
                                      span, dtype=jnp.int64)
            got = rng.randint(rng.PRNGKey(seed), 64, span,
                              partitionable=part)
            assert np.array_equal(got.numpy(), _np(want)), span


@pytest.mark.parametrize("part", MODES)
def test_randint_per_sample_spans(part):
    """The sampler's child draws: one span per sample, mixed sizes."""
    r = np.random.default_rng(0)
    spans = np.concatenate([np.asarray(SPANS, np.int64),
                            r.integers(1, 2 ** 62, 30, dtype=np.int64),
                            r.integers(1, 2 ** 33, 30, dtype=np.int64)])
    with threefry_mode(part):
        key = jax.random.PRNGKey(5)
        want = jax.random.randint(key, spans.shape, 0, jnp.asarray(spans),
                                  dtype=jnp.int64)
        got = rng.randint(rng.PRNGKey(5), len(spans), torch.as_tensor(spans),
                          partitionable=part)
    assert np.array_equal(got.numpy(), _np(want))


def test_randint_from_bits_matches_the_kernel_reduction():
    """The limb arithmetic equals jax's uint64 reduction (the Pallas
    kernel's ``randint_from_bits``), wrap-around included."""
    r = np.random.default_rng(1)
    n = 200
    hi = r.integers(0, 2 ** 63, n, dtype=np.uint64) * np.uint64(2) \
        + r.integers(0, 2, n, dtype=np.uint64)
    lo = r.integers(0, 2 ** 63, n, dtype=np.uint64) * np.uint64(2) \
        + r.integers(0, 2, n, dtype=np.uint64)
    spans = np.concatenate([np.asarray(SPANS, np.int64),
                            r.integers(1, 2 ** 63 - 1, n - len(SPANS),
                                       dtype=np.int64)])
    want = jax_rfb(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(spans))
    got = rng.randint_from_bits(torch.as_tensor(hi.view(np.int64)),
                                torch.as_tensor(lo.view(np.int64)),
                                torch.as_tensor(spans))
    assert np.array_equal(got.numpy(), _np(want))

"""Threefry-2x32 draws, as ``jax.random`` makes them (partitionable mode).

A frozen copy of the pieces of the port's ``core/rng.py`` that the
estimator's sampling keys need: ``PRNGKey``, ``fold_in``, ``split``,
``bits`` and ``randint``.  The port draws every sample of chunk ``j``
from ``fold_in(PRNGKey(seed), j)``; the reference has to draw the same
bits to re-derive the same samples, so this is the one part of the
reference that copies the port instead of restating the paper.

A key is an int64 tensor ``[..., 2]`` of two uint32 words; 64-bit draws
are int64 tensors holding the uint64 bit pattern; all arithmetic is on
32-bit limbs in int64 and never overflows.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_I64_MIN = -(1 << 63)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher, 20 rounds, elementwise."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the 64-bit seed as two words."""
    s = int(seed) & ((1 << 64) - 1)
    return torch.tensor([s >> 32, s & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``, ``data`` taken mod 2^32."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def _hash(key, x0, x1):
    return threefry2x32(key[..., 0:1], key[..., 1:2], x0, x1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., 2] -> [..., num, 2]``."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    b0, b1 = _hash(key, i >> 32, i & _M32)
    return torch.stack([b0, b1], dim=-1)


def _join64(hi, lo):
    body = ((hi & 0x7FFFFFFF) << 32) | lo
    return torch.where(hi >= (1 << 31), body | _I64_MIN, body)


def bits(key: torch.Tensor, K: int) -> torch.Tensor:
    """``jax.random.bits(key, (K,), uint64)`` as int64 bit patterns."""
    i = torch.arange(K, dtype=torch.int64, device=key.device)
    b0, b1 = _hash(key, i >> 32, i & _M32)
    return _join64(b0, b1)


def _addmod(x, y, s):
    t = x - (s - y)
    return torch.where(t >= 0, t, t.clamp(max=-1) + s)


def _mulmod_small(x, y, s):
    a = (x * (y >> 16)) % s
    return (a * 65536 + x * (y & 0xFFFF)) % s


def _u64mod(u, s):
    r62 = (1 << 62) % s
    r63 = _addmod(r62, r62, s)
    low = (u & ((1 << 63) - 1)) % s
    return torch.where(u < 0, _addmod(low, r63, s), low)


def randint_from_bits(hi, lo, span):
    """jax's double-width reduction of two 64-bit draws into
    ``[0, span)``: ``((hi % s) * ((2^32 % s)^2 % s) + lo % s) % s``,
    whose multiplier wraps to 0 in uint64 once ``span > 2^32``."""
    small = span <= (1 << 32)
    ss = torch.where(small, span, torch.ones_like(span))
    c = (1 << 32) % ss
    mult = _mulmod_small(c, c, ss)
    out_small = (_mulmod_small(_u64mod(hi, ss), mult, ss)
                 + _u64mod(lo, ss)) % ss
    return torch.where(small, out_small, _u64mod(lo, span))


def randint(key: torch.Tensor, K: int, maxval) -> torch.Tensor:
    """``jax.random.randint(key, (K,), 0, maxval, int64)``."""
    k = split(key, 2)
    hi = bits(k[..., 0, :], K)
    lo = bits(k[..., 1, :], K)
    span = torch.as_tensor(maxval, dtype=torch.int64, device=key.device)
    span = torch.broadcast_to(span.clamp(min=1), hi.shape)
    return randint_from_bits(hi, lo, span)

"""Threefry-2x32 counter-based RNG, bit-exact to ``jax.random``.

The JAX reference draws every random number of an estimate from
``jax.random`` keys: chunk ``j`` from ``fold_in(PRNGKey(seed), j)``, the
sampler from ``split(key, S + 2)`` and ``randint`` on those.  For the
port to return the reference's counts bit for bit it must draw the same
bits, so this module re-implements the pieces it needs from jax's own
sources (``jax/_src/prng.py``: ``threefry_2x32``, ``_threefry_seed``,
``_threefry_split_foldlike`` / ``_threefry_split_original``,
``threefry_fold_in``, ``_threefry_random_bits_partitionable`` /
``_threefry_random_bits_original``; ``jax/_src/random.py: _randint``).

``partitionable=True`` matches jax's default (``jax_threefry_partitionable
= True`` since jax 0.5); ``partitionable=False`` matches the legacy mode.

Representation: a key is an int64 tensor ``[..., 2]`` holding two uint32
words; leading dimensions batch independent keys.  uint32 values live in
int64 tensors and 64-bit draws are int64 tensors holding the uint64 bit
pattern — torch has no ``+``, ``%``, ``>>`` or ``<`` for uint64 on the
CPU, so all arithmetic here is on 32-bit limbs in int64 and never
overflows (no reliance on signed wrap-around).
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_I64_MIN = -(1 << 63)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher, 20 rounds, elementwise.

    All four arguments are int64 tensors of uint32 values that broadcast
    together; returns the two output words.
    """
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


def PRNGKey(seed: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the 64-bit seed split into two words."""
    s = int(seed) & ((1 << 64) - 1)
    return torch.tensor([s >> 32, s & _M32], dtype=torch.int64,
                        device=device)


def _hash(key: torch.Tensor, x0, x1):
    return threefry2x32(key[..., 0:1], key[..., 1:2], x0, x1)


def split(key: torch.Tensor, num: int = 2, *,
          partitionable: bool = True) -> torch.Tensor:
    """``jax.random.split``: ``[..., 2] -> [..., num, 2]``."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    if partitionable:
        b0, b1 = _hash(key, i >> 32, i & _M32)
        return torch.stack([b0, b1], dim=-1)
    y0, y1 = _hash(key, i, i + num)
    flat = torch.cat([y0, y1], dim=-1)
    return flat.reshape(*key.shape[:-1], num, 2)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` (the same in both modes).

    ``data`` is an int or an int64 tensor broadcasting against the
    key's leading dimensions; it is taken modulo 2^32 like jax's uint32
    cast.
    """
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def _join64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two uint32 words -> the int64 holding ``hi << 32 | lo`` (no wrap)."""
    body = ((hi & 0x7FFFFFFF) << 32) | lo
    return torch.where(hi >= (1 << 31), body | _I64_MIN, body)


def bits(key: torch.Tensor, K: int, *, partitionable: bool = True
         ) -> torch.Tensor:
    """``jax.random.bits(key, (K,), uint64)`` as int64 bit patterns.

    ``key [..., 2] -> [..., K]``.
    """
    i = torch.arange(K, dtype=torch.int64, device=key.device)
    if partitionable:
        return bits_at(key, i)
    y0, y1 = _hash(key, i, i + K)
    return _join64(y0, y1)


def bits_at(key: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Entries ``idx`` of ``bits(key, K)`` in the partitionable mode, each
    from its own counter: ``threefry2x32(key, idx >> 32, idx & M32)``.

    ``key [..., 2]``, ``idx [N]`` int64 -> ``[..., N]``.
    """
    b0, b1 = _hash(key, idx >> 32, idx & _M32)
    return _join64(b0, b1)


# ---------------------------------------------------------------------------
# randint: jax's double-width modular reduction, on limbs
# ---------------------------------------------------------------------------
def _addmod(x, y, s):
    """``(x + y) % s`` for ``x, y`` in ``[0, s)``, ``s < 2^63``, no overflow."""
    t = x - (s - y)
    return torch.where(t >= 0, t, t.clamp(max=-1) + s)


def _mulmod_small(x, y, s):
    """``(x * y) % s`` for ``x, y`` in ``[0, s)`` and ``s <= 2^32``."""
    a = (x * (y >> 16)) % s
    return (a * 65536 + x * (y & 0xFFFF)) % s


def _u64mod(u, s):
    """``u % s`` where ``u`` holds a uint64 bit pattern, ``1 <= s < 2^63``."""
    r62 = (1 << 62) % s
    r63 = _addmod(r62, r62, s)
    low = (u & ((1 << 63) - 1)) % s       # u - 2^63 when the top bit is set
    return torch.where(u < 0, _addmod(low, r63, s), low)


def randint_from_bits(hi: torch.Tensor, lo: torch.Tensor,
                      span: torch.Tensor) -> torch.Tensor:
    """``jax.random.randint(key, shape, 0, span, int64)`` from the two
    64-bit draws of its internal key split, exactly as jax reduces them::

        c    = 2^32 % span            (uint64)
        mult = (c * c) % span         (wraps mod 2^64: 0 once span > 2^32)
        out  = ((hi % span) * mult + lo % span) % span

    For ``span <= 2^32`` no term wraps, so it is evaluated exactly on
    limbs; for ``span > 2^32`` ``mult`` is 0 and the draw is
    ``lo % span``.  ``span`` is an int64 tensor in ``[1, 2^63)``.
    """
    small = span <= (1 << 32)
    ss = torch.where(small, span, torch.ones_like(span))
    c = (1 << 32) % ss
    mult = _mulmod_small(c, c, ss)
    out_small = (_mulmod_small(_u64mod(hi, ss), mult, ss)
                 + _u64mod(lo, ss)) % ss
    return torch.where(small, out_small, _u64mod(lo, span))


def randint(key: torch.Tensor, K: int, maxval, *,
            partitionable: bool = True) -> torch.Tensor:
    """``jax.random.randint(key, (K,), 0, maxval, dtype=int64)``.

    ``key [..., 2] -> [..., K]``; ``maxval`` is an int or int64 tensor
    broadcasting against the output (``maxval <= 0`` gives zeros).
    """
    k = split(key, 2, partitionable=partitionable)
    hi = bits(k[..., 0, :], K, partitionable=partitionable)
    lo = bits(k[..., 1, :], K, partitionable=partitionable)
    span = torch.as_tensor(maxval, dtype=torch.int64, device=key.device)
    span = torch.broadcast_to(span.clamp(min=1), hi.shape)
    return randint_from_bits(hi, lo, span)


# ---------------------------------------------------------------------------
# uniform: jax's mantissa fill of 32- or 64-bit draws
# ---------------------------------------------------------------------------
def bits32(key: torch.Tensor, n: int, *, partitionable: bool = True
           ) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` as int64 tensors of uint32
    values; ``key [2] -> [n]``.

    Partitionable: word ``i`` is the xor of the two output words of
    ``threefry2x32(key, i >> 32, i & M32)``.  Original: the counters
    ``0 .. n-1`` (padded with one zero to an even count) are hashed as
    two halves, and the outputs concatenated.
    """
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    if partitionable:
        b0, b1 = _hash(key, i >> 32, i & _M32)
        return b0 ^ b1
    half = -(-n // 2)
    x = torch.cat([i, i.new_zeros(2 * half - n)])
    y0, y1 = _hash(key, x[:half], x[half:])
    return torch.cat([y0, y1])[:n]


def _unit_f32(b: torch.Tensor) -> torch.Tensor:
    """uint32 draws -> jax's float32 ``uniform`` values in ``[0, 1)``."""
    one = (b >> 9) | 0x3F800000
    return (one.to(torch.int32).view(torch.float32) - 1.0).clamp(min=0.0)


def uniform_at(key: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Entries ``idx`` (flat, int64) of ``uniform(key, shape, float32)``
    in the partitionable mode, where element ``i`` depends on ``(key,
    i)`` alone: a slice of a leaf's draws without drawing the leaf."""
    b0, b1 = _hash(key, idx >> 32, idx & _M32)
    return _unit_f32(b0 ^ b1)


def uniform(key: torch.Tensor, shape, dtype=torch.float32, *,
            partitionable: bool = True) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype)`` in ``[0, 1)``, bit for bit:
    the top mantissa bits of one draw per element (32-bit draws for
    float32, 64-bit for float64, as jax sizes them) under an exponent of
    one, minus one.  ``key [2]``."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    if dtype == torch.float32:
        return _unit_f32(bits32(key, n, partitionable=partitionable)
                         ).reshape(shape)
    elif dtype == torch.float64:
        b = bits(key, n, partitionable=partitionable)
        one = ((b >> 12) & ((1 << 52) - 1)) | 0x3FF0000000000000
        f = one.view(torch.float64) - 1.0
    else:
        raise ValueError(f"uniform: float32 or float64, not {dtype}")
    return f.clamp(min=0.0).reshape(shape)

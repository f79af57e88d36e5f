// jax.random's threefry2x32 bits inside a kernel, bit for bit.
//
// The device twin of repro_torch/core/rng.py (itself a copy of
// jax/_src/prng.py) in jax's partitionable mode, the port's default:
//
//   split(key, n)[i]  = threefry2x32(key, (i >> 32, i & 0xffffffff))
//   bits(key, K)[i]   = hi << 32 | lo  of the same block at counter i
//   fold_in(key, d)   = threefry2x32(key, (0, d))
//
// Hopper has native 32- and 64-bit integer arithmetic, so the words wrap
// exactly as jax's uint32 and uint64 do.
#pragma once
#include <stdint.h>

namespace repro_torch {

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// The Threefry-2x32 block cipher, 20 rounds: rotations (13, 15, 26, 6)
// and (17, 29, 16, 24), key schedule (k0, k1, k0 ^ k1 ^ 0x1BD11BDA).
__device__ __forceinline__ Key threefry2x32(Key key, uint32_t x0,
                                            uint32_t x1) {
  const uint32_t ks[3] = {key.k0, key.k1, key.k0 ^ key.k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return {x0, x1};
}

// jax.random.split(key, n)[i], partitionable mode.
__device__ __forceinline__ Key split_at(Key key, uint64_t i) {
  return threefry2x32(key, (uint32_t)(i >> 32), (uint32_t)i);
}

// jax.random.bits(key, (K,), uint64)[i], partitionable mode.
__device__ __forceinline__ uint64_t bits_at(Key key, uint64_t i) {
  const Key b = threefry2x32(key, (uint32_t)(i >> 32), (uint32_t)i);
  return (uint64_t)b.k0 << 32 | b.k1;
}

// jax.random.fold_in(key, data).
__device__ __forceinline__ Key fold_in(Key key, uint32_t data) {
  return threefry2x32(key, 0u, data);
}

// jax.random.randint's reduction of its two 64-bit draws against span
// (jax/_src/random.py:_randint): mult wraps to 0 once span > 2^32, as
// jax's uint64 does.
__device__ __forceinline__ uint64_t randint_from_bits(uint64_t hi, uint64_t lo,
                                                      uint64_t span) {
  const uint64_t c = (1ULL << 32) % span;
  const uint64_t mult = (c * c) % span;
  return ((hi % span) * mult + (lo % span)) % span;
}

}  // namespace repro_torch

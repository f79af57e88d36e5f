// Shared segment bisection for the port's CUDA kernels.
//
// Replaces the Pallas-side shared body repro/kernels/bisect.py:seg_bisect
// (and core/bisect.py:monotone_find), used by both interval_weight.cu and
// tree_sampler.cu, so there is one device copy of the loop, as on the
// TPU side.  Same (l, h) trajectory as the torch searches in
// repro_torch/core/bisect.py; a thread stops as soon as its interval has
// converged, which leaves the result unchanged (the remaining fixed trips
// of the reference are no-ops).  All values are int64; gathers are
// clamped to [0, nmax] like the reference's.
#pragma once
#include <stdint.h>

namespace repro_torch {

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo, int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Smallest p in [lo, hi] with vals[p] >= target (> target when upper);
// hi if none.  vals[nmax] is the last valid element.
__device__ __forceinline__ int64_t seg_bisect(const int64_t* __restrict__ vals,
                                              int64_t nmax, int64_t lo,
                                              int64_t hi, int64_t target,
                                              bool upper, int iters) {
  int64_t l = lo, h = hi;
  for (int i = 0; i < iters && l < h; ++i) {
    int64_t mid = (l + h) >> 1;
    int64_t v = vals[clamp64(mid, 0, nmax)];
    bool go_right = upper ? (v <= target) : (v < target);
    if (go_right) {
      l = mid + 1;
    } else {
      h = mid;
    }
  }
  return l;
}

// Generalized inverse CDF: smallest p in [lo, hi) with g(p + 1) > r, for a
// non-decreasing g with g(lo) == 0 and 0 <= r < g(hi).
template <class G>
__device__ __forceinline__ int64_t monotone_find(G g, int64_t lo, int64_t hi,
                                                 int64_t r, int iters) {
  int64_t l = lo, h = hi;
  for (int i = 0; i < iters && h - l > 1; ++i) {
    int64_t mid = (l + h) >> 1;
    if (g(mid) <= r) {
      l = mid;
    } else {
      h = mid;
    }
  }
  return l;
}

}  // namespace repro_torch

// Shared segment searches for the port's CUDA kernels.
//
// Replaces the Pallas-side shared body repro/kernels/bisect.py:seg_bisect
// (and core/bisect.py:monotone_find), used by both interval_weight.cu and
// tree_sampler.cu, so there is one device copy of each search, as on the
// TPU side.  All values are int64; gathers are clamped to [0, nmax] like
// the reference's.
//
// Every search here has a unique answer on the sorted segments and
// non-decreasing functions the kernels give it:
//
//   seg_bisect     the smallest p in [lo, hi) with vals[p] >= target
//                  (> target when upper), hi if none;
//   monotone_find  the largest p in [lo, hi) with p == lo or g(p) <= r.
//
// So any search order returns the same bits as the torch searches in
// repro_torch/core/bisect.py (whose trip count bisect_iters(m) covers
// every segment and never binds).  Two orders are kept:
//
//   * scalar seg_bisect: one thread halves its interval, stopping once it
//     has converged (the remaining fixed trips of the reference are
//     no-ops); the dep-sum's searches and the sampler's nested pair
//     search;
//   * group (G = 8, 16 or 32 aligned lanes of one warp, all on the same
//     search; the sampler runs 8): in each step the lanes probe G evenly
//     spaced pivots and __ballot_sync picks the sub-interval, which
//     shrinks the interval G + 1 times a step instead of twice.
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

// G aligned lanes of one warp working on one search.  Every lane of the
// group must reach every call with the same (l, h); the results are the
// same on every lane.
template <int W>
struct LaneGroup {
  static_assert(W == 8 || W == 16 || W == 32, "group of 8, 16 or 32 lanes");
  unsigned mask;  // the group's lanes in the warp
  int base;       // its first lane
  int rank;       // this lane's place in the group

  __device__ __forceinline__ LaneGroup() {
    const int lane = threadIdx.x & 31;
    base = lane & ~(W - 1);
    rank = lane - base;
    mask = W == 32 ? 0xffffffffu : (((1u << (W & 31)) - 1u) << base);
  }

  // bit j set when lane j of the group passed pred
  __device__ __forceinline__ unsigned ballot(bool pred) const {
    return (__ballot_sync(mask, pred) & mask) >> base;
  }

  __device__ __forceinline__ int64_t shfl(int64_t v, int src) const {
    return __shfl_sync(mask, (long long)v, base + src);
  }
};

// Smallest p in [l, h) with pred(p), h if none, for a pred that is false
// then true along [l, h).  Each step probes G pivots splitting [l, h)
// into G + 1 parts (or every position once h - l <= G).
template <int W, class P>
__device__ __forceinline__ int64_t group_first_true(const LaneGroup<W>& grp,
                                                    int64_t l, int64_t h,
                                                    P pred) {
  while (l < h) {
    const int64_t n = h - l;
    if (n <= W) {
      const unsigned b = grp.ballot(grp.rank < n && pred(l + grp.rank));
      return b ? l + (__ffs(b) - 1) : h;
    }
    const unsigned b = grp.ballot(pred(l + n * (grp.rank + 1) / (W + 1)));
    if (b) {
      const int j = __ffs(b) - 1;         // first pivot that passed
      const int64_t hit = l + n * (j + 1) / (W + 1);
      if (j > 0) l = l + n * j / (W + 1) + 1;
      h = hit;
    } else {
      l = l + n * W / (W + 1) + 1;
    }
  }
  return l;
}

// seg_bisect by a group of lanes: the same answer.
template <int W>
__device__ __forceinline__ int64_t group_seg_bisect(
    const LaneGroup<W>& grp, const int64_t* __restrict__ vals, int64_t nmax,
    int64_t lo, int64_t hi, int64_t target, bool upper) {
  return group_first_true(grp, lo, hi, [&](int64_t p) {
    const int64_t v = vals[clamp64(p, 0, nmax)];
    return upper ? v > target : v >= target;
  });
}

// monotone_find by a group of lanes: the same answer.  The scalar search
// never evaluates g(lo) and ends on the last p whose g(p) <= r, so its
// result is one before the first p in (lo, hi) with g(p) > r (hi if
// none), and lo when hi - lo <= 1.
template <int W, class G>
__device__ __forceinline__ int64_t group_monotone_find(const LaneGroup<W>& grp,
                                                       G g, int64_t lo,
                                                       int64_t hi, int64_t r) {
  if (hi - lo <= 1) return lo;
  return group_first_true(grp, lo + 1, hi,
                          [&](int64_t p) { return g(p) > r; }) - 1;
}

}  // namespace repro_torch

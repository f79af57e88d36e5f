// Dep-sum kernel: one whole Claim 4.9 dep-sum of the TIMEST weight DP.
//
// Replaces the Pallas kernel repro/kernels/interval_weight/kernel.py
// (_iw_kernel, launched by interval_weight_call), together with the query
// arrays its caller built and the second launch for the Claim 4.8
// exclusion.  For every edge e, under one dependency (meet_end, alpha,
// beta), one window (own: i = t/wd, prev: i = t/wd - 1), delta and wd:
//
//   tlo, thi  = the beta side of t[e] within delta, cut to window i
//   brk       = (i + 1) wd, where own weights give way to prev weights
//   Lambda    = IW(csr_t, pso, psp, [ptr[meet], ptr[meet + 1]))
//   El        = IW(pair_t, ppo, ppp, the pair list of e)   (with C2)
//   out       = Lambda - El, in meet-vertex order (see Design)
//
// where IW(vals, own, prev, [a, b)) = (own[pmid] - own[plo]) +
// (prev[phi] - prev[pmid]) with plo = lower_bound(tlo), phi =
// upper_bound(thi), pmid = clip(lower_bound(brk), plo, phi) in the
// segment.  Everything is int64 (no 2^24 gate, no f32).
//
// What bounds it on the H100: memory.  The function must read each
// edge's time, meet vertex and pair id, the CSR pointers and times, the
// pair pointers and times and the child's four prefixes, and write the
// output: ~(72 m + 8 n + 8 P) B with C2, ~0.62 GB, ~0.18 ms at 3.35 TB/s
// at m = 7.8 M.  Taken in edge (time) order, every access would be a
// scattered 8 B read of a 32 B sector of its own: neighbouring lanes
// would search unrelated segments and gather each edge's meet vertex and
// pair id at its id.
//
// Design:
//   * The queries are built in registers from the edge itself; the five
//     [m] query arrays of the plain version (dep_sum_queries) never exist
//     in device memory, and Lambda and El come out of one launch.
//   * Thread i takes edge perm[i], perm being the CSR that groups edges
//     by their meet vertex (out_edge for meet_end 0, in_edge for 1), so a
//     warp's edges mostly share one segment with ascending times, and
//     neighbouring lanes' searches probe the same few cache lines.  The
//     edge's time, meet vertex and pair id come in the same order (the
//     host gathers them once per graph and dependency kind), so they are
//     read coalesced, and the result is stored in that order too: a
//     store at the edge's own slot would cost a scattered 8 B write, and
//     the wrapper's one gather back to edge order costs less than that.
//     Only the pair-list searches stay scattered.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bisect.cuh"

// Mirrors the ctypes Structure in interval_weight/ops.py field for field;
// every field is 8 bytes, so the layout has no padding.
struct DepSumArgs {
  const int64_t* perm_t;   // [m] t[perm[i]], perm grouping edges by meet
                           // vertex
  const int32_t* meet;     // [m] meet vertex of edge perm[i]
  const int32_t* pid;      // [m] pair list of edge perm[i] (-1: none)
  const int64_t* ptr;      // [n + 1] alpha-CSR pointers
  const int64_t* csr_t;    // [m] alpha-CSR times
  const int64_t* pso;      // [m + 1] child's own prefix, alpha-CSR order
  const int64_t* psp;      // [m + 1] child's prev prefix
  const int64_t* pair_ptr;
  const int64_t* pair_t;
  const int64_t* ppo;      // [m + 1] child's own prefix, pair order
  const int64_t* ppp;
  int64_t* out;            // [m] the result of edge perm[i] at i
  int64_t m, delta, wd, prev, before, use_c2;
};

namespace {

using repro_torch::max64;
using repro_torch::min64;
using repro_torch::seg_bisect;

constexpr int THREADS = 256;
constexpr int TRIPS = 64;   // covers any int64 range; searches stop early

// IW over the segment [lo, hi): phi is searched from plo (tlo <= thi)
// and brk inside [plo, phi], which gives clip(lower_bound(brk), plo, phi)
// exactly.
__device__ __forceinline__ int64_t two_piece_sum(
    const int64_t* __restrict__ vals, const int64_t* __restrict__ own,
    const int64_t* __restrict__ prv, int64_t nmax, int64_t lo, int64_t hi,
    int64_t tlo, int64_t thi, int64_t brk) {
  const int64_t plo = seg_bisect(vals, nmax, lo, hi, tlo, false, TRIPS);
  const int64_t phi = seg_bisect(vals, nmax, plo, hi, thi, true, TRIPS);
  const int64_t pmid = seg_bisect(vals, nmax, plo, phi, brk, false, TRIPS);
  return (own[pmid] - own[plo]) + (prv[phi] - prv[pmid]);
}

__global__ void __launch_bounds__(THREADS) dep_sum_kernel(const DepSumArgs a) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.m) return;
  const int64_t nmax = a.m - 1;

  // -- the edge's queries, in registers ---------------------------------
  const int64_t t = a.perm_t[i];
  const int64_t meet = a.meet[i];
  const int64_t win = t / a.wd - a.prev;   // t >= 0: floor division
  int64_t tlo, thi;
  if (a.before) {
    tlo = max64(t - a.delta, win * a.wd);
    thi = t;
  } else {
    tlo = t;
    thi = min64(t + a.delta, (win + 2) * a.wd - 1);
  }
  const int64_t brk = (win + 1) * a.wd;

  // -- Lambda minus the pair-list exclusion ------------------------------
  int64_t w = two_piece_sum(a.csr_t, a.pso, a.psp, nmax, a.ptr[meet],
                            a.ptr[meet + 1], tlo, thi, brk);
  if (a.use_c2) {
    const int64_t pid = a.pid[i];
    if (pid >= 0) {   // no list: an empty range, which sums to 0
      w -= two_piece_sum(a.pair_t, a.ppo, a.ppp, nmax, a.pair_ptr[pid],
                         a.pair_ptr[pid + 1], tlo, thi, brk);
    }
  }
  a.out[i] = w;
}

}  // namespace

extern "C" int dep_sum_launch(const DepSumArgs* args, void* stream) {
  const int64_t blocks = (args->m + THREADS - 1) / THREADS;
  dep_sum_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      *args);
  return (int)cudaGetLastError();
}

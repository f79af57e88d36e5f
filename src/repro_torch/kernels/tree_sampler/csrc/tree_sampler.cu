// Tree-sampler kernel: all of TIMEST Alg. 3 for one sample per thread.
//
// Replaces the Pallas kernel repro/kernels/tree_sampler/kernel.py
// (_sampler_kernel, launched by tree_sampler_call; host side in ops.py).
// Per sample k, on precomputed draws (x[k], uhi[k, :], ulo[k, :]):
//
//   1. window  i ~ W_i / W     bisect the window-prefix CDF ps_win;
//   2. center  e0 ~ w_root     two-piece (own|prev) inverse CDF over the
//                              window's edge range;
//   3. children, along the static top-down schedule: bisect the meet
//      vertex's alpha-CSR segment to the window-truncated time bounds,
//      exclude the parallel-edge pair list (Claim 4.8) by a nested
//      bisection into its position sub-sequence, draw the target with
//      jax's randint reduction against the in-kernel span, and find the
//      child edge by the generalized inverse CDF.
//
// Everything is int64 (prefixes, times, targets) and the draws are
// uint64, so the kernel is exact at every graph size: the Pallas kernel
// ran f32 prefixes behind a 2^24 gate and never ran on a real graph.
// randint_from_bits is jax's _randint reduction in unsigned long long,
// which wraps mod 2^64 exactly as jax's uint64 does.
//
// What bounds it on the H100: memory latency.  A sample is a chain of
// dependent random 8 B gathers (per child: ~3 log2(deg) time words, then
// ~log2(deg) steps of the inverse CDF each doing a nested log2(pairs)
// bisection and four prefix reads); the bytes it must move are small
// (draws 8 + 16 S, outputs 8 (S + 1), plus the gathered words), so at
// K = 8192 the kernel is bound by the depth of that chain, not by the
// 3.35 TB/s of HBM.
//
// Design: one thread per sample (128 per block), the graph and weights
// read straight from device memory (the ~GB of prefixes do not fit in
// shared memory; the 50 MB L2 holds the hot segments), the schedule of
// at most MAX_STEPS (parent, child, meet_end, alpha, beta, use_rev) steps
// passed by value in the kernel argument, and the bisection body shared
// with the interval-weight kernel (bisect.cuh).  Warp-cooperative search
// and more samples in flight are left for a later change.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bisect.cuh"

constexpr int MAX_STEPS = 15;
constexpr int MAX_EDGES = MAX_STEPS + 1;

struct Step {
  int64_t parent, child, meet_end, alpha, beta, use_rev;
};

// Mirrors the ctypes Structure in tree_sampler/ops.py field for field;
// every field is 8 bytes, so the layout has no padding.
struct SamplerArgs {
  const int64_t* t;
  const int32_t* src;
  const int32_t* dst;
  const int64_t* out_ptr;
  const int64_t* in_ptr;
  const int64_t* out_t;
  const int64_t* in_t;
  const int32_t* out_edge;
  const int32_t* in_edge;
  const int64_t* pair_pos_out;
  const int64_t* pair_pos_in;
  const int64_t* pair_ptr;
  const int64_t* pair_t;
  const int32_t* pair_id;
  const int32_t* rev_pair_id;
  const int64_t* ps_win;
  const int64_t* win_lo;
  const int64_t* win_mid;
  const int64_t* win_hi;
  const int64_t* ps_acc_own;
  const int64_t* ps_acc_prev;
  const int64_t* ps_pair_own;
  const int64_t* ps_pair_prev;
  const int64_t* x;
  const uint64_t* uhi;
  const uint64_t* ulo;
  int64_t* edges;
  int64_t* window;
  int64_t K, m, S, q, root, use_c2, it, itq, delta, wd, n_steps;
  Step steps[MAX_STEPS];
};

namespace {

using repro_torch::clamp64;
using repro_torch::max64;
using repro_torch::min64;
using repro_torch::monotone_find;
using repro_torch::seg_bisect;

// jax.random.randint's reduction of its two 64-bit draws against span.
__device__ __forceinline__ uint64_t randint_from_bits(uint64_t hi, uint64_t lo,
                                                      uint64_t span) {
  const uint64_t c = (1ULL << 32) % span;
  const uint64_t mult = (c * c) % span;
  return ((hi % span) * mult + (lo % span)) % span;
}

// C(p) = (PSo[min(p,mid)] - PSo[lo]) + (PSp[max(p,mid)] - PSp[mid]).
struct TwoPiece {
  const int64_t* pso;
  const int64_t* psp;
  int64_t mid, base_own, base_prev, nmax;
  __device__ TwoPiece(const int64_t* o, const int64_t* p, int64_t lo,
                      int64_t mid_, int64_t nmax_)
      : pso(o), psp(p), mid(mid_), nmax(nmax_) {
    base_own = pso[clamp64(lo, 0, nmax)];
    base_prev = psp[clamp64(mid, 0, nmax)];
  }
  __device__ __forceinline__ int64_t operator()(int64_t p) const {
    const int64_t a = p < mid ? p : mid;
    const int64_t b = p > mid ? p : mid;
    return (pso[clamp64(a, 0, nmax)] - base_own) +
           (psp[clamp64(b, 0, nmax)] - base_prev);
  }
};

__global__ void __launch_bounds__(128)
tree_sampler_kernel(const SamplerArgs a) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= a.K) return;
  const int64_t m = a.m;
  const int64_t nmax = m - 1;   // last index of the [m] arrays
  const int64_t pmax = m;       // last index of the [m + 1] prefixes
  const int it = (int)a.it;

  // -- 1. window ------------------------------------------------------
  const int64_t x = a.x[k];
  int64_t win = seg_bisect(a.ps_win, a.q, 0, a.q, x, true, (int)a.itq) - 1;
  win = clamp64(win, 0, a.q - 1);
  const int64_t resid = x - a.ps_win[win];

  // -- 2. center edge -------------------------------------------------
  const int64_t lo = a.win_lo[win], mid = a.win_mid[win], hi = a.win_hi[win];
  int64_t edges[MAX_EDGES];
  {
    const TwoPiece C(a.ps_acc_own + a.root * (m + 1),
                     a.ps_acc_prev + a.root * (m + 1), lo, mid, pmax);
    edges[a.root] = monotone_find(C, lo, hi, resid, it);
  }

  // -- 3. children, top-down (static schedule) --------------------------
  for (int st = 0; st < a.n_steps; ++st) {
    const Step sp = a.steps[st];
    const int64_t e = edges[sp.parent];
    const int64_t meet = sp.meet_end == 0 ? a.src[e] : a.dst[e];
    const int64_t te = a.t[e];
    const bool out = sp.alpha > 0;
    const int64_t* ptr = out ? a.out_ptr : a.in_ptr;
    const int64_t* csr_t = out ? a.out_t : a.in_t;
    const int32_t* csr_edge = out ? a.out_edge : a.in_edge;
    const int64_t* pair_pos = out ? a.pair_pos_out : a.pair_pos_in;
    const int64_t p0 = ptr[meet], p1 = ptr[meet + 1];
    int64_t tlo, thi;
    if (sp.beta < 0) {  // BEFORE
      tlo = max64(te - a.delta, win * a.wd);
      thi = te;
    } else {
      tlo = te;
      thi = min64(te + a.delta, (win + 2) * a.wd - 1);
    }
    const int64_t brk = (win + 1) * a.wd;
    const int64_t plo = seg_bisect(csr_t, nmax, p0, p1, tlo, false, it);
    const int64_t phi = seg_bisect(csr_t, nmax, p0, p1, thi, true, it);
    const int64_t pmid =
        min64(max64(seg_bisect(csr_t, nmax, p0, p1, brk, false, it), plo), phi);
    const int64_t off = sp.child * (m + 1);
    const TwoPiece CL(a.ps_acc_own + off, a.ps_acc_prev + off, plo, pmid,
                      pmax);
    int64_t pstar;
    if (a.use_c2) {
      const int64_t pid = sp.use_rev ? a.rev_pair_id[e] : a.pair_id[e];
      const int64_t pid0 = pid > 0 ? pid : 0;
      const int64_t q0 = a.pair_ptr[pid0];
      const int64_t q1 = pid >= 0 ? a.pair_ptr[pid0 + 1] : q0;
      const int64_t qlo = seg_bisect(a.pair_t, nmax, q0, q1, tlo, false, it);
      const int64_t qhi = seg_bisect(a.pair_t, nmax, q0, q1, thi, true, it);
      const int64_t qmid = min64(
          max64(seg_bisect(a.pair_t, nmax, q0, q1, brk, false, it), qlo), qhi);
      const TwoPiece CE(a.ps_pair_own + off, a.ps_pair_prev + off, qlo, qmid,
                        pmax);
      auto g = [&](int64_t p) {
        const int64_t cross = seg_bisect(pair_pos, nmax, qlo, qhi, p, false, it);
        return CL(p) - CE(cross);
      };
      const int64_t wx = g(phi);
      const uint64_t span = (uint64_t)(wx > 1 ? wx : 1);
      const int64_t rx =
          (int64_t)randint_from_bits(a.uhi[k * a.S + sp.child],
                                     a.ulo[k * a.S + sp.child], span);
      pstar = monotone_find(g, plo, phi, rx, it);
    } else {
      const int64_t wx = CL(phi);
      const uint64_t span = (uint64_t)(wx > 1 ? wx : 1);
      const int64_t rx =
          (int64_t)randint_from_bits(a.uhi[k * a.S + sp.child],
                                     a.ulo[k * a.S + sp.child], span);
      pstar = monotone_find(CL, plo, phi, rx, it);
    }
    edges[sp.child] = csr_edge[clamp64(pstar, 0, nmax)];
  }

  for (int s = 0; s < a.S; ++s) a.edges[k * a.S + s] = edges[s];
  a.window[k] = win;
}

}  // namespace

extern "C" int tree_sampler_launch(const SamplerArgs* args, void* stream) {
  if (args->n_steps > MAX_STEPS || args->S > MAX_EDGES) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = 128;
  const int64_t blocks = (args->K + threads - 1) / threads;
  tree_sampler_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      *args);
  return (int)cudaGetLastError();
}

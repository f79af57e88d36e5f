// Tree-sampler kernel: all of TIMEST Alg. 3, drawing its own bits.
//
// Replaces the Pallas kernel repro/kernels/tree_sampler/kernel.py
// (_sampler_kernel, launched by tree_sampler_call; host side in ops.py),
// together with the draws the host made for it (ops.prepare_draws).  One
// launch samples a chunk of K samples for each of J streams (the chunk
// keys of a tree cohort's seeds, keys [J, 2]): the stream is the grid's
// y dimension, as a vmap over the key stack gives the Pallas kernel a
// grid axis, and stream i's output is that of a launch on keys[i] alone.
// For sample k of a stream's chunk:
//
//   0. draws     jax's threefry bits of the chunk key, bit for bit
//                (threefry.cuh): keys = split(key, S + 2); the target
//                x = randint(keys[0], K, max(W, 1))[k] and, per child c,
//                the two 64-bit draws of randint(keys[2 + c], ...)[k];
//   1. window    i ~ W_i / W: bisect the window-prefix CDF ps_win;
//   2. center    e0 ~ w_root: two-piece (own|prev) inverse CDF over the
//                window's edge range;
//   3. children, along the static top-down schedule: bisect the meet
//      vertex's alpha-CSR segment to the window-truncated time bounds,
//      exclude the parallel-edge pair list (Claim 4.8) by a nested
//      bisection into its position sub-sequence, reduce the child's draws
//      against the in-kernel span with jax's randint, and find the child
//      edge by the generalized inverse CDF.
//
// Everything is int64 (prefixes, times, targets) and the draws uint64,
// so the kernel is exact at every graph size; randint_from_bits wraps
// mod 2^64 as jax's uint64 does (mult is 0 once W > 2^32).
//
// What bounds it on the H100: memory latency.  A sample is a chain of
// dependent random 8 B gathers (per child: three searches of the meet
// vertex's segment, three of its pair list, then the inverse CDF, whose
// every step runs a nested search of the pair list and reads four
// prefix words); the bytes it must move are small (the key, outputs
// 8 (S + 1) B a sample, plus the gathered words), so at K = 8192 it is
// bound by the depth of that chain, not by the 3.35 TB/s of HBM.
//
// Design:
//   * A group of G = 8 lanes per sample (8 timed faster than 16 and 32
//     on an H100: fewer lanes keep more samples in flight and waste fewer
//     probes on short segments).  Each search and each inverse CDF runs
//     G-ary (bisect.cuh): the lanes
//     probe G pivots at once, each evaluating its own g(p), with its own
//     nested pair search, and a ballot picks the sub-interval, so the
//     chain is about log(G + 1) / log(2) times shorter than bisection.
//     Every search has a unique answer, so the order changes no bit.
//   * The draws cost no memory traffic: the block derives its stream's
//     chunk keys once into shared memory (S + 2 threefry blocks and their
//     splits) and each lane then computes its sample's bits from the
//     sample index as counter.  The key and W are read on the device, so
//     the host waits on nothing.
//   * The graph and weights are read straight from device memory (the GB
//     of prefixes do not fit in shared memory; the 50 MB L2 holds the hot
//     segments); the schedule of at most MAX_STEPS (parent, child,
//     meet_end, alpha, beta, use_rev) steps is passed by value.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bisect.cuh"
#include "threefry.cuh"

constexpr int MAX_STEPS = 15;
constexpr int MAX_EDGES = MAX_STEPS + 1;
constexpr int THREADS = 256;
constexpr int G = 8;   // lanes per sample

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
  const int64_t* W_total;  // 0-d
  const int64_t* key;      // [J, 2] uint32 words, one chunk key a stream
  int64_t* edges;          // [J, K, S]
  int64_t* window;         // [J, K]
  int64_t K, m, S, q, root, use_c2, it, delta, wd, n_steps, J;
  Step steps[MAX_STEPS];
};

namespace {

using repro_torch::Key;
using repro_torch::LaneGroup;
using repro_torch::bits_at;
using repro_torch::clamp64;
using repro_torch::group_first_true;
using repro_torch::group_monotone_find;
using repro_torch::group_seg_bisect;
using repro_torch::max64;
using repro_torch::min64;
using repro_torch::randint_from_bits;
using repro_torch::seg_bisect;
using repro_torch::split_at;

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

// jax's randint(key, ...)[k] against span, from the two keys its split
// gives: the per-sample half of the draw schedule.
__device__ __forceinline__ int64_t draw(Key hi_key, Key lo_key, uint64_t k,
                                        int64_t span) {
  return (int64_t)randint_from_bits(bits_at(hi_key, k), bits_at(lo_key, k),
                                    (uint64_t)(span > 1 ? span : 1));
}

__global__ void __launch_bounds__(THREADS)
tree_sampler_kernel(const SamplerArgs a) {
  // -- 0. the stream's chunk keys, once per block ---------------------------
  // slot 0: the two keys of the window target's randint; slot 1 + c: the
  // two of child c's randint
  const int64_t stream = blockIdx.y;
  __shared__ Key keys[1 + MAX_EDGES][2];
  if (threadIdx.x < a.S + 2 && threadIdx.x != 1) {
    const Key chunk = {(uint32_t)a.key[2 * stream],
                       (uint32_t)a.key[2 * stream + 1]};
    const Key ki = split_at(chunk, threadIdx.x);   // split(key, S + 2)[i]
    const int slot = threadIdx.x == 0 ? 0 : threadIdx.x - 1;
    keys[slot][0] = split_at(ki, 0);
    keys[slot][1] = split_at(ki, 1);
  }
  __syncthreads();

  const LaneGroup<G> grp;
  const int64_t k = ((int64_t)blockIdx.x * THREADS + threadIdx.x) / G;
  if (k >= a.K) return;   // whole groups leave together
  const int64_t m = a.m;
  const int64_t nmax = m - 1;   // last index of the [m] arrays
  const int64_t pmax = m;       // last index of the [m + 1] prefixes
  const int it = (int)a.it;

  // -- 1. window ------------------------------------------------------
  const int64_t x = draw(keys[0][0], keys[0][1], k, *a.W_total);
  int64_t win = group_seg_bisect(grp, a.ps_win, a.q, 0, a.q, x, true) - 1;
  win = clamp64(win, 0, a.q - 1);
  const int64_t resid = x - a.ps_win[win];

  // -- 2. center edge -------------------------------------------------
  const int64_t lo = a.win_lo[win], mid = a.win_mid[win], hi = a.win_hi[win];
  int64_t edges[MAX_EDGES];
  {
    const TwoPiece C(a.ps_acc_own + a.root * (m + 1),
                     a.ps_acc_prev + a.root * (m + 1), lo, mid, pmax);
    edges[a.root] = group_monotone_find(grp, C, lo, hi, resid);
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
    // phi >= plo when tlo <= thi, so phi is searched from plo then; pmid
    // = clip(lower_bound(brk), plo, phi) is brk's bound inside [plo, phi],
    // and phi itself when phi < plo
    const int64_t plo = group_seg_bisect(grp, csr_t, nmax, p0, p1, tlo, false);
    const int64_t phi = group_seg_bisect(grp, csr_t, nmax,
                                         tlo <= thi ? plo : p0, p1, thi, true);
    const int64_t pmid =
        phi < plo ? phi
                  : group_seg_bisect(grp, csr_t, nmax, plo, phi, brk, false);
    const int64_t off = sp.child * (m + 1);
    const TwoPiece CL(a.ps_acc_own + off, a.ps_acc_prev + off, plo, pmid,
                      pmax);
    const Key* ck = keys[1 + sp.child];
    int64_t pstar;
    if (a.use_c2) {
      const int64_t pid = sp.use_rev ? a.rev_pair_id[e] : a.pair_id[e];
      const int64_t pid0 = pid > 0 ? pid : 0;
      const int64_t q0 = a.pair_ptr[pid0];
      const int64_t q1 = pid >= 0 ? a.pair_ptr[pid0 + 1] : q0;
      const int64_t qlo =
          group_seg_bisect(grp, a.pair_t, nmax, q0, q1, tlo, false);
      const int64_t qhi = group_seg_bisect(grp, a.pair_t, nmax,
                                           tlo <= thi ? qlo : q0, q1, thi,
                                           true);
      const int64_t qmid =
          qhi < qlo ? qhi
                    : group_seg_bisect(grp, a.pair_t, nmax, qlo, qhi, brk,
                                       false);
      const TwoPiece CE(a.ps_pair_own + off, a.ps_pair_prev + off, qlo, qmid,
                        pmax);
      // each lane's own nested search: the lanes of a group probe
      // different p
      auto g = [&](int64_t p) {
        const int64_t cross = seg_bisect(pair_pos, nmax, qlo, qhi, p, false, it);
        return CL(p) - CE(cross);
      };
      const int64_t rx = draw(ck[0], ck[1], k, g(phi));
      pstar = group_monotone_find(grp, g, plo, phi, rx);
    } else {
      const int64_t rx = draw(ck[0], ck[1], k, CL(phi));
      pstar = group_monotone_find(grp, CL, plo, phi, rx);
    }
    edges[sp.child] = csr_edge[clamp64(pstar, 0, nmax)];
  }

  const int64_t row = stream * a.K + k;
  for (int s = grp.rank; s < a.S; s += G) a.edges[row * a.S + s] = edges[s];
  if (grp.rank == 0) a.window[row] = win;
}

}  // namespace

extern "C" int tree_sampler_launch(const SamplerArgs* args, void* stream) {
  if (args->n_steps > MAX_STEPS || args->S > MAX_EDGES || args->J < 1 ||
      args->J > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t blocks = (args->K * G + THREADS - 1) / THREADS;
  const dim3 grid((unsigned)blocks, (unsigned)args->J);
  tree_sampler_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

// Interval-weight kernel: the Claim 4.9 dep-sum of the TIMEST weight DP.
//
// Replaces the Pallas kernel repro/kernels/interval_weight/kernel.py
// (_iw_kernel, launched by interval_weight_call).  Per query q:
//
//   plo  = lower_bound(csr_t, p0, p1, tlo)
//   phi  = upper_bound(csr_t, p0, p1, thi)
//   pmid = clip(lower_bound(csr_t, p0, p1, brk), plo, phi)
//   out  = (ps_own[pmid] - ps_own[plo]) + (ps_prev[phi] - ps_prev[pmid])
//
// Everything is int64 (times, prefixes, queries, output): the Pallas
// kernel ran f32 prefixes behind a 2^24 exactness gate, which real graphs
// (W ~ 1e12) fail; here there is no gate and no VMEM budget.
//
// What bounds it on the H100: memory.  A query reads 5 x 8 B of query
// words and writes 8 B, and its three bisections gather about
// 3 * log2(segment length) time words plus four prefix words, each a
// random 8 B access that costs a full 32 B sector.  At Q = m = 7.8M the
// minimum traffic (each input read once, each output written once) is
// ~(3 m + 6 Q) * 8 B ~ 0.56 GB, ~0.17 ms at 3.35 TB/s; the gathers make
// the real traffic several times that.
//
// Design: one thread per query, a grid-stride-free 1-D launch on the
// caller's stream; the bisection body is the shared one (bisect.cuh) and
// stops when its interval has converged.  Neighbouring queries are
// neighbouring edges, so in the DP their segments often coincide and the
// gathers hit L2.  Shared-memory staging and warp-cooperative search are
// left for a later change.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bisect.cuh"

namespace {

__global__ void interval_weight_kernel(
    const int64_t* __restrict__ csr_t, const int64_t* __restrict__ ps_own,
    const int64_t* __restrict__ ps_prev, const int64_t* __restrict__ p0,
    const int64_t* __restrict__ p1, const int64_t* __restrict__ tlo,
    const int64_t* __restrict__ thi, const int64_t* __restrict__ brk,
    int64_t* __restrict__ out, int64_t m, int64_t Q, int iters) {
  using repro_torch::seg_bisect;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const int64_t a = p0[i], b = p1[i];
  const int64_t nmax = m - 1;
  const int64_t plo = seg_bisect(csr_t, nmax, a, b, tlo[i], false, iters);
  const int64_t phi = seg_bisect(csr_t, nmax, a, b, thi[i], true, iters);
  int64_t pmid = seg_bisect(csr_t, nmax, a, b, brk[i], false, iters);
  pmid = pmid > plo ? pmid : plo;  // jnp.clip: min(max(x, lo), hi)
  pmid = pmid < phi ? pmid : phi;
  out[i] = (ps_own[pmid] - ps_own[plo]) + (ps_prev[phi] - ps_prev[pmid]);
}

}  // namespace

extern "C" int interval_weight_launch(
    const void* csr_t, const void* ps_own, const void* ps_prev,
    const void* p0, const void* p1, const void* tlo, const void* thi,
    const void* brk, void* out, int64_t m, int64_t Q, int64_t iters,
    void* stream) {
  const int threads = 256;
  const int64_t blocks = (Q + threads - 1) / threads;
  interval_weight_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const int64_t*)csr_t, (const int64_t*)ps_own, (const int64_t*)ps_prev,
      (const int64_t*)p0, (const int64_t*)p1, (const int64_t*)tlo,
      (const int64_t*)thi, (const int64_t*)brk, (int64_t*)out, m, Q,
      (int)iters);
  return (int)cudaGetLastError();
}

// EmbeddingBag (sum) kernel: out[b] = sum_j w[b, j] * table[idx[b, j]],
// f32 accumulation over the bag and one rounding to the table's dtype,
// for the sparse lookup of the recsys path (DCN-v2's sparse features).
//
// Replaces the Pallas kernel repro/kernels/embedding_bag/kernel.py
// (_eb_kernel, launched by embedding_bag_padded) together with the slot
// rules of its wrapper repro/kernels/embedding_bag/ops.py: a slot with
// idx < 0 is padding and adds nothing (the wrapper there clamps it to
// row 0 with weight 0), a missing weight is 1, and an id past the table
// is clamped to its last row (what the reference's gather does).  There
// the grid is (bag, slot) with the output block resident across slots,
// and the running sum is rounded to the output dtype after every slot;
// here a bag's sum stays in f32 registers and is rounded once, so bf16
// multi-hot bags differ from the Pallas kernel by up to about `bag` ulps,
// and a bag of one slot of weight 1 is the table row bit for bit.
//
// What bounds it on the H100: bytes.  DCN-v2's bulk serving batch
// (262,144 rows x 26 features, one id each, d = 16 in bf16) reads 6.8 M
// ids (int64, 54.5 MB) and 6.8 M table rows (218 MB) and writes 218 MB,
// 0.146 ms at 3.35 TB/s; the arithmetic is one FMA per element read.
// The rows are 32 bytes at random places of a 2 GB table, so the reads
// are scattered sectors, not streams.
//
// Design (a simple first version): a group of tpr threads per bag (tpr a
// power of two up to 32, enough for 16-byte loads to cover a row), each
// thread a 16-byte chunk of the row (two threads per 32-byte bf16 row of
// d = 16, sixteen bags per warp), looping over the bag's slots; row
// offsets are int64 (the full table has 1.0e9 elements).  Rows whose
// width or address does not allow 16-byte loads take one element per
// load.
//
// An f32-output mode (flags bit 3) writes a bf16 table's bag sums in f32,
// unrounded: a table sharded by rows sums its ranks' partial bags in f32
// and rounds once, as one process rounds its whole bag once.
//
// What it leaves on the table: latency hiding.  Each thread has one row
// load in flight per slot; several bags per thread, or prefetching the
// next slot's id, would keep more of the scattered reads in flight.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

template <typename T, int VEC>
struct Chunk;  // VEC elements of T as one load
template <>
struct Chunk<float, 4> {
  using V = float4;
  static __device__ __forceinline__ void to_f32(const V& v, float* f) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  static __device__ __forceinline__ V from_f32(const float* f) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <>
struct Chunk<bf16, 8> {
  using V = uint4;
  static __device__ __forceinline__ void to_f32(const V& v, float* f) {
    const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(h[e]);
  }
  static __device__ __forceinline__ V from_f32(const float* f) {
    V v;
    bf16* h = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int e = 0; e < 8; ++e) h[e] = __float2bfloat16(f[e]);
    return v;
  }
};
template <>
struct Chunk<float, 1> {
  using V = float;
  static __device__ __forceinline__ void to_f32(const V& v, float* f) {
    f[0] = v;
  }
  static __device__ __forceinline__ V from_f32(const float* f) {
    return f[0];
  }
};
template <>
struct Chunk<bf16, 1> {
  using V = bf16;
  static __device__ __forceinline__ void to_f32(const V& v, float* f) {
    f[0] = __bfloat162float(v);
  }
  static __device__ __forceinline__ V from_f32(const float* f) {
    return __float2bfloat16(f[0]);
  }
};

// VEC f32 sums stored as O: the table's dtype (one chunk store) or f32
// (VEC / 4 float4 stores, one store per element when VEC is 1)
template <typename T, typename O, int VEC>
struct Store {
  static __device__ __forceinline__ void to(O* dst, const float* acc) {
    using C = Chunk<T, VEC>;
    *reinterpret_cast<typename C::V*>(dst) = C::from_f32(acc);
  }
};
template <int VEC>
struct Store<bf16, float, VEC> {
  static __device__ __forceinline__ void to(float* dst, const float* acc) {
    if constexpr (VEC == 1) {
      dst[0] = acc[0];
    } else {
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        *reinterpret_cast<float4*>(dst + e) =
            make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
    }
  }
};

template <typename T, typename O, typename I, int VEC>
__global__ void __launch_bounds__(256)
embedding_bag_kernel(const T* __restrict__ table, const I* __restrict__ idx,
                     const float* __restrict__ weights, O* __restrict__ out,
                     int64_t V, int64_t B, int bag, int d, int tpr) {
  using C = Chunk<T, VEC>;
  const int64_t gt = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t b = gt / tpr;
  if (b >= B) return;
  const int lane = (int)(gt % tpr);
  const I* ib = idx + b * bag;
  const float* wb = weights ? weights + b * bag : nullptr;
  for (int c0 = lane * VEC; c0 < d; c0 += tpr * VEC) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int j = 0; j < bag; ++j) {
      const int64_t id = (int64_t)ib[j];
      if (id < 0) continue;  // padding slot
      const int64_t row = id < V ? id : V - 1;
      const float wj = wb ? wb[j] : 1.f;
      float f[VEC];
      C::to_f32(*reinterpret_cast<const typename C::V*>(table + row * d + c0),
                f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(wj, f[e], acc[e]);
    }
    Store<T, O, VEC>::to(out + b * d + c0, acc);
  }
}

template <typename T, typename O, typename I>
int launch_typed(const void* table, const void* idx, const void* w,
                 void* out, int64_t V, int64_t B, int bag, int d, int vec,
                 cudaStream_t s) {
  constexpr int VW = 16 / sizeof(T);
  const int per_thread = vec ? VW : 1;
  int tpr = 1;
  while (tpr < 32 && tpr * per_thread < d) tpr *= 2;
  const int64_t threads = B * tpr;
  const int64_t blocks = (threads + 255) / 256;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  const T* t = static_cast<const T*>(table);
  const I* ix = static_cast<const I*>(idx);
  const float* wf = static_cast<const float*>(w);
  O* o = static_cast<O*>(out);
  if (vec)
    embedding_bag_kernel<T, O, I, VW><<<(unsigned)blocks, 256, 0, s>>>(
        t, ix, wf, o, V, B, bag, d, tpr);
  else
    embedding_bag_kernel<T, O, I, 1><<<(unsigned)blocks, 256, 0, s>>>(
        t, ix, wf, o, V, B, bag, d, tpr);
  return (int)cudaGetLastError();
}

}  // namespace

// flags: bit 0 = bf16 table (else f32), bit 1 = int64 ids (else int32),
// bit 2 = 16-byte loads allowed, bit 3 = f32 output of a bf16 table (else
// the table's dtype).  weights may be null (all ones).
extern "C" int embedding_bag_launch(const void* table, const void* idx,
                                    const void* weights, void* out,
                                    int64_t V, int64_t d, int64_t B,
                                    int64_t bag, int64_t flags,
                                    void* stream) {
  if (B == 0 || d == 0) return 0;
  if (d > INT32_MAX || bag > INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int vec = (int)((flags >> 2) & 1);
  const int b16 = (int)(flags & 1), i64 = (int)((flags >> 1) & 1);
  const int o32 = (int)((flags >> 3) & 1);
  if (o32 && !b16) return (int)cudaErrorInvalidValue;
  if (b16 && o32 && i64)
    return launch_typed<bf16, float, int64_t>(table, idx, weights, out, V,
                                              B, (int)bag, (int)d, vec, s);
  if (b16 && o32)
    return launch_typed<bf16, float, int32_t>(table, idx, weights, out, V,
                                              B, (int)bag, (int)d, vec, s);
  if (b16 && i64)
    return launch_typed<bf16, bf16, int64_t>(table, idx, weights, out, V, B,
                                             (int)bag, (int)d, vec, s);
  if (b16)
    return launch_typed<bf16, bf16, int32_t>(table, idx, weights, out, V, B,
                                             (int)bag, (int)d, vec, s);
  if (i64)
    return launch_typed<float, float, int64_t>(table, idx, weights, out, V,
                                               B, (int)bag, (int)d, vec, s);
  return launch_typed<float, float, int32_t>(table, idx, weights, out, V, B,
                                             (int)bag, (int)d, vec, s);
}

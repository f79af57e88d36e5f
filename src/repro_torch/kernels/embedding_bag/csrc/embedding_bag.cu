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
// here a bag's sum stays in f32 registers, its slots added in order, and
// is rounded once, so bf16 multi-hot bags differ from the Pallas kernel
// by up to about `bag` ulps, and a bag of one slot of weight 1 is the
// table row bit for bit.  An f32-output mode (flags bit 3) writes a bf16
// table's bag sums in f32, unrounded: a table sharded by rows sums its
// ranks' partial bags in f32 and rounds once, as one process rounds its
// whole bag once.
//
// What bounds it on the H100: bytes, and the rows are scattered.
// DCN-v2's bulk serving batch (262,144 rows x 26 features, one id each,
// d = 16 in bf16) reads 6.8 M ids (int64, 54.5 MB) and 6.8 M table rows
// (218 MB) and writes 218 MB: 0.146 ms at 3.35 TB/s counted so.  Each row
// is 32 bytes at a random place of a 2 GB table, and DRAM serves a
// scattered 32-byte read as a 64-byte access, so the bytes the card
// moves are about 709 MB, 0.2115 ms; the arithmetic is one FMA per
// element read.  Timed variants (scripts/embedding_bag_variants.py) put
// this lookup at the same 0.24-0.25 ms whether a thread has 2 or 16 row
// loads in flight: the DRAM, not latency, holds it.  Small batches (a
// mesh rank's 852 K bags, 85% of them padding, f32 output) are bound by
// their output writes and by how evenly the bags spread over the SMs.
//
// Design.  A group of tpr threads takes a bag (tpr a power of two up to
// 32, each thread a 16-byte chunk of the row: two threads a 32-byte bf16
// row), so a block of kThreads covers kThreads / tpr consecutive bags a
// round; a block takes BPT consecutive rounds (a batch, e.g. 4 x 64 bags
// of one), a thread one bag of each, and a thread loads SPG = kInFlight /
// BPT slots of each of its bags at once (a stage): it reads their ids
// and sends every row chunk to its own slots of a shared-memory ring by
// cp.async (no register held while the copy flies), then the weights,
// and only then waits and sums.  A stage of a longer bag (or a further
// chunk column of a wide row) is sent before the one before it is summed,
// so kInFlight to 2 * kInFlight row chunks are in flight.  One block a
// batch: the hardware hands small blocks to the SMs as they free up, so
// a batch that does not fill the card's waves ends on at most one short
// block (a persistent grid measured slower on every lookup timed).  The
// output of a round is one contiguous run, written 16 bytes a thread.
// Cache hints (streaming or L2 evict-first loads, streaming stores) moved
// no time in this design and are not used.  A padding slot costs its id
// read and nothing else; an all-pad bag costs its ids and its store.
// Rows whose width or address does not allow 16-byte copies take the
// one-element kernel (registers, kInFlight slots at once; correct, not
// fast).  Row offsets are int64 (the full table has 1.0e9 elements).
//
// The wrapper (ops.py launch_geometry) chooses tpr, BPT and the grid.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // a block
constexpr int kInFlight = 8;   // row chunks a thread sends in one stage

// an id or a weight (a streaming load, __ldcs, timed no faster)
template <typename X>
__device__ __forceinline__ X ld_once(const X* p) {
  return __ldg(p);
}

// 16 bytes of output (a streaming store, __stcs, timed no faster)
__device__ __forceinline__ void st16(void* p, uint4 v) {
  *static_cast<uint4*>(p) = v;
}

template <typename T, int VEC>
struct Chunk;  // 16 bytes of T (VEC elements) to f32 and back
template <>
struct Chunk<float, 4> {
  using V = uint4;
  static __device__ __forceinline__ void to_f32(const V& v, float* f) {
    f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ V from_f32(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Chunk<bf16, 8> {
  using V = uint4;
  // each 32-bit word holds elements 2i (low half) and 2i + 1 (high half)
  static __device__ __forceinline__ void pair(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ void to_f32(const V& v, float* f) {
    pair(v.x, f); pair(v.y, f + 2); pair(v.z, f + 4); pair(v.w, f + 6);
  }
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ V from_f32(const float* f) {
    return make_uint4(pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]),
                      pack(f[6], f[7]));
  }
};
// one element widened to f32, and an f32 sum stored as one element (the
// one-element kernel)
__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void put(bf16* dst, float v) {
  *dst = __float2bfloat16(v);
}

// VEC f32 sums stored as O: the table's dtype (one 16-byte store) or f32
// (VEC / 4 16-byte stores)
template <typename T, typename O, int VEC>
__device__ __forceinline__ void store(O* dst, const float* acc) {
  if constexpr (sizeof(O) == sizeof(T)) {
    st16(dst, Chunk<T, VEC>::from_f32(acc));
  } else {
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      st16(dst + e, Chunk<float, 4>::from_f32(acc + e));
  }
}

// The 16-byte path.  A stage is one slot group (SPG slots of each of a
// thread's BPT bags) at one chunk column c0: send() reads its ids and
// weights and sends its row chunks to the thread's own slots of a
// shared-memory ring by cp.async, which holds no register while the
// copy is in flight.  A thread sends stage t + 1 before it waits for
// stage t and sums it, so up to 2 * kInFlight row chunks and the next
// stage's ids are in flight while it sums and stores.
template <int BPT>
struct Stage {
  static constexpr int SPG = kInFlight / BPT;  // slots of a bag at once
  int64_t r0;  // the batch: bags (r0 * BPT + k) * groups + g
  int c0, j0;  // chunk column, first slot
  uint32_t live;  // bit k * SPG + s: slot s of bag k adds a row
  float wt[kInFlight];

  template <typename T, typename I, int VEC>
  __device__ __forceinline__ void send(uint4 (*ring)[kThreads],
                                       const T* table, const I* idx,
                                       const float* weights, int64_t V,
                                       int64_t B, int bag, int d, int groups,
                                       int g) {
    const int64_t b0 = r0 * BPT * groups + g;
    int64_t row[kInFlight];
    live = 0;
#pragma unroll
    for (int k = 0; k < BPT; ++k)
#pragma unroll
      for (int s = 0; s < SPG; ++s) {
        const int64_t b = b0 + k * groups;
        int64_t id = -1;
        if (b < B && j0 + s < bag) id = ld_once(idx + b * bag + j0 + s);
        live |= (uint32_t)(id >= 0) << (k * SPG + s);
        row[k * SPG + s] = id < V ? id : V - 1;
      }
#pragma unroll
    for (int i = 0; i < kInFlight; ++i)
      if (live >> i & 1)
        repro_torch::cp_async::copy16(&ring[i][threadIdx.x],
                                      table + row[i] * d + c0, 16);
    repro_torch::cp_async::commit();
#pragma unroll
    for (int k = 0; k < BPT; ++k)
#pragma unroll
      for (int s = 0; s < SPG; ++s) {
        const int i = k * SPG + s;
        wt[i] = weights && (live >> i & 1)
                    ? ld_once(weights + (b0 + k * groups) * bag + j0 + s)
                    : 1.f;
      }
  }
};

// BPT > 1 only for bags of at most SPG slots (one stage a bag); BPT = 1
// carries one bag's sums over the stages of a longer bag.
template <typename T, typename O, typename I, int BPT>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table, const I* __restrict__ idx,
                     const float* __restrict__ weights, O* __restrict__ out,
                     int64_t V, int64_t B, int bag, int d, int tpr) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int SPG = Stage<BPT>::SPG;
  using C = Chunk<T, VEC>;
  __shared__ uint4 ring[2][kInFlight][kThreads];
  const int groups = kThreads / tpr;  // bags a round
  const int g = threadIdx.x / tpr, lane = threadIdx.x % tpr;
  const int64_t rounds = (B + groups - 1) / groups;
  const int64_t batches = (rounds + BPT - 1) / BPT;
  Stage<BPT> cur;
  cur.r0 = blockIdx.x;
  cur.c0 = lane * VEC;
  cur.j0 = 0;
  if (cur.r0 >= batches || cur.c0 >= d) return;
  cur.template send<T, I, VEC>(ring[0], table, idx, weights, V, B, bag, d,
                               groups, g);
  float acc[VEC];  // one bag's sums over its stages (BPT = 1)
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  for (int par = 0;; par ^= 1) {
    Stage<BPT> nxt = cur;  // the stage after cur
    nxt.j0 += SPG;
    if (nxt.j0 >= bag) {
      nxt.j0 = 0;
      nxt.c0 += tpr * VEC;
      if (nxt.c0 >= d) {
        nxt.c0 = lane * VEC;
        nxt.r0 += gridDim.x;
      }
    }
    const bool more = nxt.r0 < batches;
    if (more) {
      nxt.template send<T, I, VEC>(ring[par ^ 1], table, idx, weights, V,
                                   B, bag, d, groups, g);
      repro_torch::cp_async::wait<1>();
    } else {
      repro_torch::cp_async::wait<0>();
    }
    const bool last = cur.j0 + SPG >= bag;  // the bags end with this stage
#pragma unroll
    for (int k = 0; k < BPT; ++k) {
      float a[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) a[e] = BPT == 1 ? acc[e] : 0.f;
#pragma unroll
      for (int s = 0; s < SPG; ++s) {
        const int i = k * SPG + s;
        if (!(cur.live >> i & 1)) continue;  // padding slot
        float f[VEC];
        C::to_f32(ring[par][i][threadIdx.x], f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) a[e] = fmaf(cur.wt[i], f[e], a[e]);
      }
      if (last) {
        const int64_t b = (cur.r0 * BPT + k) * groups + g;
        if (b < B) store<T, O, VEC>(out + b * d + cur.c0, a);
#pragma unroll
        for (int e = 0; e < VEC; ++e) a[e] = 0.f;
      }
      if (BPT == 1) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = a[e];
      }
    }
    if (!more) return;
    cur = nxt;
  }
}

// The one-element path (rows whose width or address rules out 16-byte
// loads): a group of tpr threads a bag, one element a thread, kInFlight
// slots of the bag loaded into registers before they are summed.
template <typename T, typename O, typename I>
__global__ void __launch_bounds__(kThreads)
embedding_bag_scalar_kernel(const T* __restrict__ table,
                            const I* __restrict__ idx,
                            const float* __restrict__ weights,
                            O* __restrict__ out, int64_t V, int64_t B,
                            int bag, int d, int tpr) {
  const int groups = kThreads / tpr;
  const int g = threadIdx.x / tpr, lane = threadIdx.x % tpr;
  const int64_t rounds = (B + groups - 1) / groups;
  for (int64_t r = blockIdx.x; r < rounds; r += gridDim.x) {
    const int64_t b = r * groups + g;
    if (b >= B) continue;
    for (int c = lane; c < d; c += tpr) {
      float acc = 0.f;
      for (int j0 = 0; j0 < bag; j0 += kInFlight) {
        int64_t row[kInFlight];
        T v[kInFlight];
#pragma unroll
        for (int s = 0; s < kInFlight; ++s) {
          const int64_t id = j0 + s < bag ? ld_once(idx + b * bag + j0 + s)
                                          : -1;
          row[s] = id < 0 ? -1 : (id < V ? id : V - 1);
        }
#pragma unroll
        for (int s = 0; s < kInFlight; ++s)
          if (row[s] >= 0) v[s] = ld_once(table + row[s] * d + c);
#pragma unroll
        for (int s = 0; s < kInFlight; ++s) {
          if (row[s] < 0) continue;  // padding slot
          const float w = weights ? ld_once(weights + b * bag + j0 + s) : 1.f;
          acc = fmaf(w, as_f32(v[s]), acc);
        }
      }
      put(out + b * d + c, acc);
    }
  }
}

template <typename T, typename O, typename I>
using KernelFn = void (*)(const T*, const I*, const float*, O*, int64_t,
                          int64_t, int, int, int);

// the 16-byte instantiation with bpt bags a thread (vec), or the
// one-element kernel (bpt 1); null for any other bpt
template <typename T, typename O, typename I>
KernelFn<T, O, I> pick(int vec, int bpt) {
  if (!vec) return bpt == 1 ? embedding_bag_scalar_kernel<T, O, I> : nullptr;
  switch (bpt) {
    case 1: return embedding_bag_kernel<T, O, I, 1>;
    case 2: return embedding_bag_kernel<T, O, I, 2>;
    case 4: return embedding_bag_kernel<T, O, I, 4>;
    default: return nullptr;
  }
}

template <typename X>
struct Tag {
  using type = X;
};

// f(Tag<table>, Tag<output>, Tag<ids>) for the types the flags name
template <typename F>
int with_types(int64_t flags, F f) {
  const int b16 = (int)(flags & 1), i64 = (int)((flags >> 1) & 1);
  const int o32 = (int)((flags >> 3) & 1);
  if (o32 && !b16) return (int)cudaErrorInvalidValue;
  if (b16 && o32 && i64) return f(Tag<bf16>{}, Tag<float>{}, Tag<int64_t>{});
  if (b16 && o32) return f(Tag<bf16>{}, Tag<float>{}, Tag<int32_t>{});
  if (b16 && i64) return f(Tag<bf16>{}, Tag<bf16>{}, Tag<int64_t>{});
  if (b16) return f(Tag<bf16>{}, Tag<bf16>{}, Tag<int32_t>{});
  if (i64) return f(Tag<float>{}, Tag<float>{}, Tag<int64_t>{});
  return f(Tag<float>{}, Tag<float>{}, Tag<int32_t>{});
}

}  // namespace

// flags: bit 0 = bf16 table (else f32), bit 1 = int64 ids (else int32),
// bit 2 = 16-byte loads allowed, bit 3 = f32 output of a bf16 table (else
// the table's dtype).  weights may be null (all ones).  tpr threads a bag
// (a power of two up to 32), bpt bags a thread (1, 2 or 4 with 16-byte
// loads, else 1; bpt > 1 only for bags of at most 8 / bpt slots), grid
// blocks of kThreads, each taking batches blockIdx.x, + grid, ...
extern "C" int embedding_bag_launch(const void* table, const void* idx,
                                    const void* weights, void* out,
                                    int64_t V, int64_t d, int64_t B,
                                    int64_t bag, int64_t flags, int64_t tpr,
                                    int64_t bpt, int64_t grid,
                                    void* stream) {
  if (B == 0 || d == 0) return 0;
  if (d > INT32_MAX || bag > INT32_MAX || grid < 1 || grid > INT32_MAX ||
      tpr < 1 || tpr > 32 || (tpr & (tpr - 1)) || bpt < 1 || bpt > 4 ||
      (bpt > 1 && bag * bpt > kInFlight))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int vec = (int)((flags >> 2) & 1);
  return with_types(flags, [&](auto t, auto o, auto i) {
    using T = typename decltype(t)::type;
    using O = typename decltype(o)::type;
    using I = typename decltype(i)::type;
    KernelFn<T, O, I> k = pick<T, O, I>(vec, (int)bpt);
    if (!k) return (int)cudaErrorInvalidValue;
    k<<<(unsigned)grid, kThreads, 0, s>>>(
        static_cast<const T*>(table), static_cast<const I*>(idx),
        static_cast<const float*>(weights), static_cast<O*>(out), V, B,
        (int)bag, (int)d, (int)tpr);
    return (int)cudaGetLastError();
  });
}

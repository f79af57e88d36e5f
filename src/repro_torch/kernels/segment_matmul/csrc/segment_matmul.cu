// Grouped-GEMM kernel: y[i] = x[i] @ w[g(i)] with one group id per
// bm-row block, f32 accumulation and the output in x's dtype, for the MoE
// expert products of the LM path (gate, up and down of every MoE layer).
//
// Replaces the Pallas kernel repro/kernels/segment_matmul/kernel.py
// (_sm_kernel, launched by segment_matmul_padded).  There the group ids
// ride in by scalar prefetch and the weight BlockSpec picks a [K, bn]
// tile of w[g] per grid step.  Here each block loads its own group id:
// row i of x [M, K] belongs to segment i / bm (bm = M / nblocks), whose
// id groups[seg] selects w[g] [K, N]; ids outside [0, G) make the block
// write NaN instead of reading outside w.
//
// What bounds it on the H100: operations at prefill, bytes at decode.
// Qwen1.5-MoE-A2.7B's prefill of 2 x 8192 tokens gives bm = C = 1368 rows
// for each of 64 experts, so a gate/up launch is 2 * 64 * 1368 * 2048 *
// 1408 = 505 GFLOP, 0.51 ms at the 989 TFLOP/s of the bf16 tensor cores
// (its 974 MB of x, w and y take 0.29 ms at 3.35 TB/s).  A decode step
// gives bm = 8: the launch must read every expert's weights once, 369 MB,
// 0.110 ms at 3.35 TB/s, and does almost no arithmetic.  Where this file
// runs on the path, the f32 MoE check (C = 2072 rows an expert, K 2048,
// N 1408 for gate/up), a launch is 765 GFLOP of f32 FMAs: 11.41 ms at
// the 67 TFLOP/s of the CUDA cores, far above its 2.0 GB of traffic.
//
// Row tiles are enumerated per segment (ceil(bm / BM) tiles each, the
// last one ragged and masked), so no tile straddles two groups and any bm
// works: 1368, 2072 and 8 on the MoE path are no multiple of a tile.  One
// block per (row tile, column tile), the column tile varying fastest, so
// the blocks that share a row tile of x run together and each reads w[g]
// once per row tile.  Warps whose 32 rows lie past the segment's tail
// skip the products.  The output is rounded once to x's dtype.  Ragged K
// and N are masked; 16-byte loads are used when K, N and the pointers
// allow.
//
// bf16 (a simple first version): 256 threads (8 warps, 4 x 2) compute a
// 128 x 128 tile with wmma 16x16x16 fragments, bf16 operands and f32
// accumulators (mma.sync on the tensor cores), k tiles of 32 staged in
// shared memory with 16-byte loads.  It runs on bf16 inputs whose K or N
// is no multiple of 8; bf16 with K and N multiples of 8, every expert
// product of the MoE path, goes to segment_matmul_sm90.cu (a TMA ring
// feeding wgmma); the wrapper in ../ops.py dispatches.  Its loads are not
// pipelined (one shared-memory stage, two barriers per k tile), and
// mma.sync issued from shared memory reaches a fraction of the bf16 peak.
//
// f32: true f32 FMAs on the CUDA cores (no TF32, since the reference
// multiplies f32 by f32 in f32), the register-blocked SGEMM: a 128 x 128
// tile, each of 256 threads an 8 x 8 patch as 2 x 2 sub-tiles of 4 x 4
// spaced 16 rows and 32 columns apart, so a k step reads four float4 of
// shared memory for 64 FMAs (0.25 words per FMA).  Two shared-memory
// stages of k depth 16, one barrier per k tile: the next tile's w
// streams in by 16-byte cp.async and its x (stored transposed, [k][row])
// is loaded into registers while this tile's 1,024 FMAs a thread run,
// then stored.  128 registers a thread, so two blocks (16 warps) share an
// SM.  Tried on the card and slower: k depth 8 or 32, one block an SM,
// 16 x 8 patches (8 or 12 warps an SM), x untransposed in a three-stage
// cp.async ring, fragments double-buffered in registers, other FMA
// orders.  Measured (chip_smoke.py, H100 80GB HBM3 at 700 W, two runs):
// the f32 check's gate/up 16.04 / 16.27 ms, 70-71% of its bound (the
// earlier 64 x 64 design: 23.31; torch.bmm in f32: 14.93 / 15.04), down
// 16.28 / 16.50 (bmm 15.92 / 16.05): a k step's four float4 reads take
// the shared-memory pipe about as long as its 64 FMAs take the FMA
// units (scripts/lds128_throughput.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

namespace cpa = repro_torch::cp_async;
using bf16 = __nv_bfloat16;
using namespace nvcuda;

// The tiles of a launch: each bm-row segment cut into per_seg row tiles,
// N cut into n_tiles column tiles.
struct Tiling {
  int64_t bm;
  int64_t per_seg;
  int64_t n_tiles;
};

struct TileAt {
  int64_t seg;   // segment (group block) of the tile
  int64_t row0;  // first row of the tile in x and y
  int rows;      // rows of the tile inside its segment
  int n0;        // first column
};

template <int BM, int BN>
__device__ __forceinline__ TileAt tile_at(const Tiling& t) {
  const int64_t bid = blockIdx.x;
  const int64_t rt = bid / t.n_tiles;
  const int64_t r = (rt % t.per_seg) * BM;
  TileAt a;
  a.seg = rt / t.per_seg;
  a.row0 = a.seg * t.bm + r;
  a.rows = (int)min((int64_t)BM, t.bm - r);
  a.n0 = (int)((bid % t.n_tiles) * BN);
  return a;
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

// A block whose group id is out of range marks its tile with NaN.
template <typename T, int BN>
__device__ void fill_nan(T* y, const TileAt& t, int N) {
  for (int e = threadIdx.x; e < t.rows * BN; e += blockDim.x) {
    const int c = t.n0 + e % BN;
    if (c < N) y[(t.row0 + e / BN) * N + c] = from_f32<T>(nanf(""));
  }
}

// ---- bf16: wmma on the tensor cores ----------------------------------
constexpr int HBM = 128, HBN = 128, HBK = 32, HTHREADS = 256;
constexpr int ALD = HBK + 8;  // row pitches (elements), multiples of 8
constexpr int BLD = HBN + 8;

// 8 consecutive elements of a row at column col of a row of len
// elements; zeros past len or when the row is outside the tile.
__device__ __forceinline__ void load8(bf16* dst, const bf16* src,
                                      bool row_ok, int col, int len,
                                      int vec) {
  if (vec && row_ok && col + 8 <= len) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = (row_ok && col + e < len) ? src[e] : __float2bfloat16(0.f);
  }
}

__global__ void __launch_bounds__(HTHREADS)
sm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const int32_t* __restrict__ groups, bf16* __restrict__ y,
               int K, int N, int G, Tiling tl, int vec) {
  __shared__ __align__(128) bf16 As[HBM * ALD];
  __shared__ __align__(128) bf16 Bs[HBK * BLD];
  __shared__ __align__(128) float Cs[HTHREADS / 32][16 * 16];
  const TileAt t = tile_at<HBM, HBN>(tl);
  const int g = groups[t.seg];
  if (g < 0 || g >= G) {
    fill_nan<bf16, HBN>(y, t, N);
    return;
  }
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1;  // rows wm * 32 .. + 32 of the tile
  const int wn = warp & 1;   // columns wn * 64 .. + 64
  const bool active = wm * 32 < t.rows;
  const bf16* xt = x + t.row0 * K;
  const bf16* wg = w + (int64_t)g * K * N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += HBK) {
    for (int c = tid; c < HBM * HBK / 8; c += HTHREADS) {
      const int r = c / (HBK / 8), kc = (c % (HBK / 8)) * 8;
      load8(As + r * ALD + kc, xt + (int64_t)r * K + k0 + kc, r < t.rows,
            k0 + kc, K, vec);
    }
    for (int c = tid; c < HBK * HBN / 8; c += HTHREADS) {
      const int kr = c / (HBN / 8), nc = (c % (HBN / 8)) * 8;
      load8(Bs + kr * BLD + nc, wg + (int64_t)(k0 + kr) * N + t.n0 + nc,
            k0 + kr < K, t.n0 + nc, N, vec);
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < HBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
            a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
            b[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * ALD + kk,
                                 ALD);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(b[j], Bs + kk * BLD + wn * 64 + j * 16,
                                 BLD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  if (!active) return;
  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = wm * 32 + i * 16 + e / 16;
        const int c = t.n0 + wn * 64 + j * 16 + e % 16;
        if (r < t.rows && c < N)
          y[(t.row0 + r) * N + c] = __float2bfloat16(cs[e]);
      }
      __syncwarp();
    }
}

// ---- f32: FMAs on the CUDA cores -------------------------------------
// A 128 x 128 tile, k tiles of 16 in two shared-memory stages.  8 warps
// as 4 (rows) x 2 (columns) warp tiles of 32 x 64; in a warp, lane
// (ly, lx) = (lane / 8, lane % 8) owns rows {0, 16} + 4 ly .. + 4 and
// columns {0, 32} + 4 lx .. + 4 of its warp tile: an 8 x 8 patch as 2 x 2
// sub-tiles of 4 x 4.  Per k step a thread reads two float4 of x (stored
// transposed, [k][row]) and two of w ([k][col]) for 64 FMAs; a
// quarter-warp's reads of x touch one chunk (broadcast), of w eight.
constexpr int FBM = 128, FBN = 128, FBK = 16, FTHREADS = 256;
constexpr int FALD = FBM + 4;  // x tile pitch: a warp's transposed
                               // stores meet at most two to a bank

template <bool VEC>
__global__ void __launch_bounds__(FTHREADS, 2)
sm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const int32_t* __restrict__ groups, float* __restrict__ y,
              int K, int N, int G, Tiling tl) {
  __shared__ __align__(16) float As[2][FBK][FALD];  // [k][row]
  __shared__ __align__(16) float Bs[2][FBK][FBN];   // [k][col]
  const TileAt t = tile_at<FBM, FBN>(tl);
  const int g = groups[t.seg];
  if (g < 0 || g >= G) {
    fill_nan<float, FBN>(y, t, N);
    return;
  }
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 64;
  const int ty = (lane >> 3) * 4, tx = (lane & 7) * 4;
  // warps whose rows lie past the segment's tail skip the FMAs
  const bool active = wr < t.rows;
  const float* xt = x + t.row0 * K;
  const float* wg = w + (int64_t)g * K * N + t.n0;

  // per k tile, a thread moves NX 4-float chunks of x (row e / XC, k
  // (e % XC) * 4) and NW of w (k e / 32, column (e % 32) * 4), e = tid +
  // 256 i
  constexpr int XC = FBK / 4, NX = FBM * XC / FTHREADS;
  constexpr int NW = FBK * (FBN / 4) / FTHREADS;
  float4 xr[NX], wr4[NW];
  auto load_x = [&](int k0) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int e = tid + i * FTHREADS, r = e / XC, kc = k0 + (e % XC) * 4;
      const float* src = xt + (int64_t)r * K + kc;
      if (VEC) {
        xr[i] = r < t.rows && kc < K
                    ? __ldg(reinterpret_cast<const float4*>(src))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[q] = r < t.rows && kc + q < K ? __ldg(src + q) : 0.f;
        xr[i] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  };
  auto store_x = [&](int buf) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int e = tid + i * FTHREADS, r = e / XC, kc = (e % XC) * 4;
      As[buf][kc + 0][r] = xr[i].x;
      As[buf][kc + 1][r] = xr[i].y;
      As[buf][kc + 2][r] = xr[i].z;
      As[buf][kc + 3][r] = xr[i].w;
    }
  };
  // w: 16-byte cp.async when VEC (N % 4 == 0: a chunk is all in or all
  // out), else masked loads through registers
  auto load_w = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int e = tid + i * FTHREADS, kr = e >> 5, nc = (e & 31) * 4;
      const int kk = k0 + kr;
      const float* src = wg + (int64_t)kk * N + nc;
      if (VEC) {
        const bool ok = kk < K && t.n0 + nc < N;
        cpa::copy16(&Bs[buf][kr][nc], ok ? src : w, ok ? 16 : 0);
      } else {
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[q] = kk < K && t.n0 + nc + q < N ? __ldg(src + q) : 0.f;
        wr4[i] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    if (VEC) cpa::commit();
  };
  auto store_w = [&](int buf) {
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int e = tid + i * FTHREADS;
      *reinterpret_cast<float4*>(&Bs[buf][e >> 5][(e & 31) * 4]) = wr4[i];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (K + FBK - 1) / FBK;
  load_x(0);
  load_w(0, 0);
  store_x(0);
  if (!VEC) store_w(0);
  cpa::wait<0>();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {  // the next k tile's loads run beside this one's FMAs
      load_x((kt + 1) * FBK);
      load_w(cur ^ 1, (kt + 1) * FBK);
    }
    if (active) {
#pragma unroll
      for (int kk = 0; kk < FBK; ++kk) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(&As[cur][kk][wr + ty]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[cur][kk][wr + 16 + ty]);
        const float4 b0 =
            *reinterpret_cast<const float4*>(&Bs[cur][kk][wc + tx]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Bs[cur][kk][wc + 32 + tx]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    if (more) {
      store_x(cur ^ 1);
      if (!VEC) store_w(cur ^ 1);
    }
    cpa::wait<0>();
    __syncthreads();  // stage cur ^ 1 complete; every read of cur done
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = wr + (i >> 2) * 16 + ty + (i & 3);
    if (r >= t.rows) continue;
    float* yr = y + (t.row0 + r) * N + t.n0;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int c = wc + jh * 32 + tx;
      const float* a = &acc[i][jh * 4];
      if (VEC) {
        if (t.n0 + c < N)
          *reinterpret_cast<float4*>(yr + c) =
              make_float4(a[0], a[1], a[2], a[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (t.n0 + c + q < N) yr[c + q] = a[q];
      }
    }
  }
}

}  // namespace

// flags: bit 0 = bf16 (else f32), bit 1 = 16-byte loads allowed.
extern "C" int segment_matmul_launch(const void* x, const void* w,
                                     const void* groups, void* y, int64_t M,
                                     int64_t K, int64_t N, int64_t nblocks,
                                     int64_t G, int64_t flags,
                                     void* stream) {
  const bool is_bf16 = flags & 1;
  const int vec = (int)((flags >> 1) & 1);
  const int64_t BM = is_bf16 ? HBM : FBM, BN = is_bf16 ? HBN : FBN;
  const int64_t bm = M / nblocks;
  const Tiling tl{bm, (bm + BM - 1) / BM, (N + BN - 1) / BN};
  const int64_t blocks = nblocks * tl.per_seg * tl.n_tiles;
  if (blocks == 0) return 0;
  if (blocks > INT32_MAX || K > INT32_MAX || N > INT32_MAX || G > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    sm_bf16_kernel<<<(unsigned)blocks, HTHREADS, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<const int32_t*>(groups), static_cast<bf16*>(y), (int)K,
        (int)N, (int)G, tl, vec);
  } else {
    // two blocks an SM: ask for the shared-memory side of the carveout
    auto kernel = vec ? sm_f32_kernel<true> : sm_f32_kernel<false>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)blocks, FTHREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const int32_t*>(groups), static_cast<float*>(y), (int)K,
        (int)N, (int)G, tl);
  }
  return (int)cudaGetLastError();
}

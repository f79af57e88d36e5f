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
// 0.110 ms at 3.35 TB/s, and does almost no arithmetic.
//
// Design (a simple first version).  Row tiles are enumerated per segment
// (ceil(bm / BM) tiles each, the last one ragged and masked), so no tile
// straddles two groups and any bm works: 1368 and 8 on the MoE path are
// no multiple of a tile.  One block per (row tile, column tile), the
// column tile varying fastest, so the blocks that share a row tile of x
// run together and each reads w[g] once per row tile.  bf16: 256 threads
// (8 warps, 4 x 2) compute a 128 x 128 tile with wmma 16x16x16
// fragments, bf16 operands and f32 accumulators (mma.sync on the tensor
// cores), k tiles of 32 staged in shared memory with 16-byte loads;
// warps whose 32 rows lie past the segment's tail skip the products.
// f32: true f32 FMAs on the CUDA cores (no TF32, since the reference
// multiplies f32 by f32 in f32), a 64 x 64 tile, each of 256 threads a
// 4 x 4 patch.  The output is rounded once to x's dtype.  Ragged K and N
// are masked; 16-byte loads are used when K, N and the pointers allow.
//
// Where it runs now: f32 inputs (the f32 MoE check) and bf16 inputs whose
// K or N is no multiple of 8.  bf16 with K and N multiples of 8, every
// expert product of the MoE path, goes to segment_matmul_sm90.cu (a TMA
// ring feeding wgmma); the wrapper in ../ops.py dispatches.  What this
// kernel leaves on the table is why: the loads are not pipelined (one
// shared-memory stage, two barriers per k tile), and mma.sync issued from
// shared memory reaches a fraction of the bf16 peak.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

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
constexpr int FBM = 64, FBN = 64, FBK = 16, FTHREADS = 256;

// 4 consecutive floats (zeros past len or outside the tile).
__device__ __forceinline__ float4 load4(const float* src, bool row_ok,
                                        int col, int len, int vec) {
  if (vec && row_ok && col + 4 <= len)
    return *reinterpret_cast<const float4*>(src);
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = (row_ok && col + e < len) ? src[e] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(FTHREADS)
sm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const int32_t* __restrict__ groups, float* __restrict__ y,
              int K, int N, int G, Tiling tl, int vec) {
  __shared__ __align__(16) float As[FBK][FBM + 4];  // transposed: [k][row]
  __shared__ __align__(16) float Bs[FBK][FBN];
  const TileAt t = tile_at<FBM, FBN>(tl);
  const int g = groups[t.seg];
  if (g < 0 || g >= G) {
    fill_nan<float, FBN>(y, t, N);
    return;
  }
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;  // rows ty*4.., columns tx*4..
  const float* xt = x + t.row0 * K;
  const float* wg = w + (int64_t)g * K * N;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FBK) {
    {  // x: 64 rows x 16 k, one chunk of 4 per thread, stored transposed
      const int r = tid >> 2, kc = (tid & 3) * 4;
      const float4 v = load4(xt + (int64_t)r * K + k0 + kc, r < t.rows,
                             k0 + kc, K, vec);
      As[kc + 0][r] = v.x;
      As[kc + 1][r] = v.y;
      As[kc + 2][r] = v.z;
      As[kc + 3][r] = v.w;
    }
    {  // w[g]: 16 k x 64 columns, one chunk of 4 per thread
      const int kr = tid >> 4, nc = (tid & 15) * 4;
      *reinterpret_cast<float4*>(&Bs[kr][nc]) =
          load4(wg + (int64_t)(k0 + kr) * N + t.n0 + nc, k0 + kr < K,
                t.n0 + nc, N, vec);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= t.rows) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = t.n0 + tx * 4 + j;
      if (c < N) y[(t.row0 + r) * N + c] = acc[i][j];
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
    sm_f32_kernel<<<(unsigned)blocks, FTHREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const int32_t*>(groups), static_cast<float*>(y), (int)K,
        (int)N, (int)G, tl, vec);
  }
  return (int)cudaGetLastError();
}

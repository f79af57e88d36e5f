// Grouped-GEMM kernel for Hopper: bf16 wgmma fed by a TMA ring,
// warp-specialised and persistent.  Serves bf16 inputs whose K and N are
// multiples of 8 (TMA's 16-byte strides), which is every expert product of
// the MoE path; segment_matmul.cu serves f32 and the other widths (the
// wrapper in ../ops.py dispatches on dtype, K and N).
//
// Replaces the Pallas kernel repro/kernels/segment_matmul/kernel.py
// (_sm_kernel, launched by segment_matmul_padded) and computes what it
// computes: y[i] = x[i] @ w[g(i)] with one group id per bm-row segment
// (bm = M / nblocks, any bm), f32 accumulation and the output rounded once
// to bf16.  A segment whose id lies outside [0, G) is written as NaN and
// reads nothing, as in segment_matmul.cu.
//
// What bounds it on the H100: operations at prefill, bytes at decode.
// Qwen1.5-MoE-A2.7B's prefill of 2 x 8192 tokens gives bm = C = 1368 rows
// for each of 64 experts: a gate/up launch is 505 GFLOP, 0.51 ms at the
// 989 TFLOP/s of the bf16 tensor cores (its 974 MB of x, w and y take
// 0.29 ms at 3.35 TB/s).  A decode step gives bm = 8: the launch reads
// every expert's weights once, 369 MB, 0.111 ms at 3.35 TB/s, and does
// almost no arithmetic.
//
// Design.  Tiles of BM rows x BN columns, enumerated per segment
// (ceil(bm / BM) row tiles each), so no tile straddles two groups; the
// column tile varies fastest.  A persistent grid of one block per SM walks
// the tiles (tile = blockIdx.x, + gridDim.x, ...), so the next tile's
// loads run under the current tile's epilogue.
//   * Warpgroup 0 is the producer: one thread issues TMA into a ring of
//     STAGES shared-memory stages of 64 k, each with a full mbarrier (TMA's
//     transactions) and an empty one (one arrival per consumer warp).  x is
//     a 3-D map [nblocks, bm, K] with boxes of 64 k x min(BM, bm rounded
//     up to 8) rows, so rows past a segment's end arrive as zeros and a
//     tile never reads the next segment's rows; w is a 3-D map [G, K, N]
//     with boxes of 64 n x 64 k, BN / 64 per stage (fewer where the
//     tile's last columns lie past N), at w's outer coordinate
//     groups[seg].  Both use the 128-byte swizzle (../../csrc/hopper.cuh);
//     K and N tails are zero-filled.
//   * Consumer warpgroups of 64 rows each issue wgmma m64nBNk16 with A = x
//     (K-major) and B = w read MN-major with the transpose bit (as V in
//     flash's P.V: SBO 1024 B, LBO the 8 KB box stride), four k steps of 16
//     per stage.  One wgmma group stays in flight: a stage is released
//     after the next stage's group is issued and wgmma_wait<1> returns.
//   * Epilogue: the f32 accumulators are rounded once to bf16 and stored
//     from registers, rows < the tile's rows in its segment and columns
//     < N only.
// Two configurations, chosen on the host by bm:
//   * prefill (bm >= 64): 128 x 256 tiles, two consumer warpgroups of
//     m64n256k16 (setmaxnreg gives them 232 registers, 128 of them
//     accumulators, and the producer 40), 4 stages of 48 KB.  Each tile
//     streams its row tile of x and column tile of w from L2, and at these
//     shapes L2 sets the pace: 128 x 128 tiles moved 8.0 GB per gate/up
//     launch at ~7 TB/s, 128 x 256 tiles move 6.2 GB (times in PERF.md);
//   * decode (bm < 64): 64 x 128 tiles, one consumer warpgroup, 8 stages
//     of 16 KB of w (plus the x box) in flight per SM for the weight
//     stream.  Rows of the 64-row A tile past the box are never written by
//     TMA; they only feed output rows that are not stored.
// Left for later: TMA multicast across a cluster (two blocks sharing one
// load of x or w halve the L2 traffic that sets the prefill's pace), an
// epilogue that overlaps the next tile's wgmma (a TMA store, or ping-pong
// consumers), fusing silu(g) * u into the epilogue, swap-AB at decode.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace repro_torch::sm90;

constexpr int BK = 64;           // k per ring stage: one 128-byte box row
constexpr int W_BOX = BK * 128;  // one 64 k x 64 n box of w, 8 KB

// BM rows x BN columns per tile (64 rows per consumer warpgroup, BN / 64
// boxes of w per stage), STAGES ring depth.
template <int BM, int BN, int STAGES>
struct Config {
  static constexpr int NC = BM / 64;              // consumer warpgroups
  static constexpr int NB = BN / 64;              // boxes of w per stage
  static constexpr int THREADS = 128 * (1 + NC);  // + the producer
  static constexpr int X_STAGE = BM * 128;        // BM rows x 64 k
  static constexpr int STAGE = X_STAGE + NB * W_BOX;
  static constexpr int BAR = STAGES * STAGE;      // full[], then empty[]
  static constexpr size_t ALLOC = BAR + 16 * STAGES + 1024;  // room to align
};

struct Params {
  const int32_t* groups;  // [nblocks]
  __nv_bfloat16* y;       // [M, N], contiguous
  int64_t bm;             // rows per segment
  int tiles;              // nblocks * per_seg * n_tiles
  int per_seg;            // row tiles per segment
  int n_tiles;            // column tiles
  int N, G, nk;           // nk = ceil(K / BK)
  uint32_t x_bytes;       // bytes of one x box
};

struct Tile {
  int64_t row0;  // first row of the tile in x and y
  int seg;       // segment
  int r0;        // first row of the tile inside its segment
  int rows;      // rows of the tile inside its segment
  int n0;        // first column
  int g;         // group id (may be out of range)
};

template <int BM, int BN>
__device__ __forceinline__ Tile tile_at(const Params& p, int tile) {
  const int per = p.per_seg * p.n_tiles;
  const int rem = tile % per;
  Tile t;
  t.seg = tile / per;
  t.r0 = (rem / p.n_tiles) * BM;
  t.n0 = (rem % p.n_tiles) * BN;
  t.row0 = (int64_t)t.seg * p.bm + t.r0;
  t.rows = (int)min((int64_t)BM, p.bm - t.r0);
  t.g = p.groups[t.seg];
  return t;
}

template <int BM, int BN, int STAGES>
__global__ void __launch_bounds__(Config<BM, BN, STAGES>::THREADS, 1)
segment_matmul_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap wmap,
                           const Params p) {
  using C = Config<BM, BN, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR);  // [STAGES]
  uint64_t* empty = full + STAGES;                              // [STAGES]

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::NC * 4);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----------------------------------------------------------
    if constexpr (C::NC == 2) setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&wmap);
      int it = 0;  // ring position, in step with the consumers'
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const Tile t = tile_at<BM, BN>(p, tile);
        if (t.g < 0 || t.g >= p.G) continue;
        const int left = (p.N - t.n0 + 63) / 64;  // boxes not wholly past N
        const int nbox = left < C::NB ? left : C::NB;
        const uint32_t bytes = p.x_bytes + nbox * W_BOX;
        for (int kt = 0; kt < p.nk; ++kt, ++it) {
          const int s = it % STAGES;
          uint8_t* st = smem + s * C::STAGE;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], bytes);
          tma_load_3d(st, &xmap, &full[s], kt * BK, t.r0, t.seg);
          for (int b = 0; b < nbox; ++b)
            tma_load_3d(st + C::X_STAGE + b * W_BOX, &wmap, &full[s],
                        t.n0 + 64 * b, kt * BK, t.g);
        }
      }
    }
  } else {
    // ---- consumers ---------------------------------------------------------
    if constexpr (C::NC == 2) setmaxnreg_inc<232>();
    const int c = wg - 1;  // which 64 rows of the tile
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int row_c = 64 * c + 16 * warp + lane / 4;  // and row_c + 8
    const int col0 = 2 * (lane % 4);
    const uint32_t base = smem_addr(smem);
    int it = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const Tile t = tile_at<BM, BN>(p, tile);
      float acc[BN / 2];
      if (t.g < 0 || t.g >= p.G) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = __int_as_float(0x7fc00000);
      } else {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
        fence_regs(acc);
        for (int kt = 0; kt < p.nk; ++kt, ++it) {
          const int s = it % STAGES;
          const uint32_t xa = base + s * C::STAGE + c * 64 * 128;
          const uint32_t wa = base + s * C::STAGE + C::X_STAGE;
          mbar_wait(&full[s], (it / STAGES) & 1);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            const uint64_t da = desc_sw128(xa + 32 * kk, 16, 1024);
            const uint64_t db = desc_sw128(wa + 2048 * kk, W_BOX, 1024);
            if constexpr (BN == 256)
              wgmma_ss_m64n256k16<1>(acc, da, db, 1);
            else
              wgmma_ss_m64n128k16<1>(acc, da, db, 1);
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's group has finished
          if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
        }
        wgmma_wait<0>();
        fence_regs(acc);
        if (p.nk > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_c + 8 * r;
        if (row >= t.rows) continue;
        __nv_bfloat16* yrow = p.y + (t.row0 + row) * (int64_t)p.N + t.n0;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = 8 * j + col0;
          if (t.n0 + col < p.N)
            *reinterpret_cast<uint32_t*>(yrow + col) =
                pack_bf16x2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

template <int BM, int BN, int STAGES>
int launch(const void* x, const void* w, const void* groups, void* y,
           int64_t M, int64_t K, int64_t N, int64_t nblocks, int64_t G,
           int64_t x_rs, int64_t w_sg, int64_t w_sk, cudaStream_t stream) {
  using C = Config<BM, BN, STAGES>;
  const int64_t bm = M / nblocks;
  const int64_t rows8 = (bm + 7) / 8 * 8;
  const uint32_t box_rows = (uint32_t)(rows8 < BM ? rows8 : BM);
  // x [nblocks, bm, K] and w [G, K, N], innermost first, strides in bytes
  const uint64_t xdims[3] = {(uint64_t)K, (uint64_t)bm, (uint64_t)nblocks};
  const uint64_t xstrides[2] = {(uint64_t)x_rs * 2,
                                (uint64_t)(bm * x_rs) * 2};
  const uint32_t xbox[3] = {BK, box_rows, 1};
  const uint64_t wdims[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)G};
  const uint64_t wstrides[2] = {(uint64_t)w_sk * 2, (uint64_t)w_sg * 2};
  const uint32_t wbox[3] = {64, BK, 1};
  CUtensorMap xmap, wmap;
  if (!repro_torch::make_map_bf16(&xmap, x, 3, xdims, xstrides, xbox) ||
      !repro_torch::make_map_bf16(&wmap, w, 3, wdims, wstrides, wbox))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.groups = static_cast<const int32_t*>(groups);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.bm = bm;
  const int64_t per_seg = (bm + BM - 1) / BM, n_tiles = (N + BN - 1) / BN;
  const int64_t tiles = nblocks * per_seg * n_tiles;
  if (tiles == 0) return 0;
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  p.per_seg = (int)per_seg;
  p.n_tiles = (int)n_tiles;
  p.tiles = (int)tiles;
  p.N = (int)N;
  p.G = (int)G;
  p.nk = (int)((K + BK - 1) / BK);
  p.x_bytes = box_rows * 128;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int grid = p.tiles < sms ? p.tiles : sms;
  auto kernel = segment_matmul_sm90_kernel<BM, BN, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::ALLOC);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, C::THREADS, C::ALLOC, stream>>>(xmap, wmap, p);
  return (int)cudaGetLastError();
}

}  // namespace

// y [M, N] = x [M, K] @ w[groups[i / bm]] for each bm-row segment i
// (bm = M / nblocks), bf16 only.  x has row stride x_rs, w strides w_sg
// (group) and w_sk (k), all in elements; the last dimensions are
// contiguous, x and w need a 16-byte aligned base and strides that are
// multiples of 8 elements, K and N must be positive multiples of 8 (the
// wrapper copies or dispatches otherwise), y is contiguous.
extern "C" int segment_matmul_sm90_launch(const void* x, const void* w,
                                          const void* groups, void* y,
                                          int64_t M, int64_t K, int64_t N,
                                          int64_t nblocks, int64_t G,
                                          int64_t x_rs, int64_t w_sg,
                                          int64_t w_sk, void* stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       x_rs % 8 == 0 && w_sg % 8 == 0 && w_sk % 8 == 0;
  if (!aligned || nblocks <= 0 || M % nblocks || K <= 0 || K % 8 ||
      N <= 0 || N % 8 || G <= 0 || K > INT32_MAX || N > INT32_MAX ||
      G > INT32_MAX || nblocks > INT32_MAX || M / nblocks > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M / nblocks >= 64)
    return launch<128, 256, 4>(x, w, groups, y, M, K, N, nblocks, G, x_rs,
                               w_sg, w_sk, s);
  return launch<64, 128, 8>(x, w, groups, y, M, K, N, nblocks, G, x_rs,
                            w_sg, w_sk, s);
}

// Flash-attention kernel for Hopper: bf16 wgmma fed by TMA, warp-specialised.
// Serves bf16 inputs at head dims 64 and 128, the LM prefill's shapes;
// flash_attention.cu serves f32 and the other head dims (the wrapper in
// ../ops.py dispatches on dtype and head dim).
//
// Replaces the Pallas kernel repro/kernels/flash_attention/kernel.py
// (_fa_kernel, launched by flash_attention_bhsd) and computes what it
// computes: GQA attention with implicit positions 0..S-1, causal and window
// masks with NEG_INF = -2^30, softcap c * tanh(s / c), an online softmax
// and the max(l, 1e-30) denominator, for ragged Sq and Skv, Sq != Skv and
// any group size, in the JAX layout [B, S, H, D].  One stated difference:
// p is rounded to bf16 before P.V (at its running max; l is summed from the
// unrounded f32 p), because wgmma takes bf16 operands.  That is what the
// LM's JAX reference does (repro/models/attention.py, _flash_inner), and
// the plain version ref.flash_attention_ref(round_p=True) follows the same
// trajectory.
//
// What bounds it on the H100.  At the Gemma-2-27B prefill's shapes (B = 2,
// S = 8192, Hq = 32, Hkv = 16, D = 128) a global layer attends 2.148e9
// (query, key) pairs: 1.10 TFLOP, 1.11 ms at 989 TFLOP/s on the tensor
// cores.  With a softcap every pair also costs three special-function
// operations (two ex2 and one rcp, below), and the SFUs give 16 a clock per
// SM: 3.87e12 a second at 132 SMs and 1.83 GHz, so 1.67 ms: the softcapped
// layers are bound by the SFUs, not the tensor cores.  Without softcap (the
// MoE prefill) one ex2 per pair: tensor-bound.  q, k, v and o are
// 403 MB, 0.12 ms at 3.35 TB/s.
//
// Design.  One block of 3 warpgroups per (128-row q tile, query head,
// batch), the heaviest causal tiles first (a 1-D grid, query head fastest,
// so every head's last tile is scheduled before any head's second-to-last).
//   * Warpgroup 0 is the producer: it gives back registers (setmaxnreg) and
//     one thread issues TMA.  Q arrives once; K and V go through a ring of
//     STAGES shared-memory stages of 128 keys, each with a full mbarrier
//     (TMA's transactions) and an empty one (one arrival per consumer
//     warp).  The kv tile range is the one flash_attention.cu computes, so
//     tiles that the causal or window mask leaves empty are never loaded.
//     Every tile is 64-column boxes with 128-byte swizzle (a D = 128 row is
//     two boxes; see ../../csrc/hopper.cuh).  TMA zero-fills rows past S;
//     a zero key still scores 0, so keys past Skv are masked.
//   * Warpgroups 1 and 2 are consumers with 64 q rows each.  S = Q.K^T is
//     wgmma m64n128k16 with A = Q and B = K from shared memory (K with D
//     contiguous is the K-major B).  The softmax runs in registers in the
//     accumulator layout: scores go to the log2 domain (scale * log2 e
//     folded in), row max across the 4 lanes of a quad by shuffles, p =
//     ex2(x - m); the row sum stays per thread until the end.  Masks are
//     applied only on tiles that cross the diagonal, the window's edge or
//     Skv; masked entries hold exactly NEG_INF before the max, as in the
//     reference.  O += P.V is wgmma with A = P from registers (the S
//     accumulator fragment packed into bf16x2 is the A fragment) and B = V
//     read MN-major (transpose bit; V's D is contiguous).
//   * The softcap's tanh is 1 - 2 / (1 + 2^(2 z log2 e)) with ex2.approx
//     and rcp.approx: absolute error ~1e-7 in tanh, ~5e-6 in a score at the
//     cap of 50 (tanh.approx.f32 would err by ~2^-11 relative, 0.024 in a
//     score).  It costs one ex2, one rcp and two FMAs per pair.
//   * Output: O / max(l, 1e-30) in bf16, rows past Sq not written.
// Left for later: ping-pong scheduling of the two consumer warpgroups,
// overlap of the softmax with the next tile's Q.K^T inside a warpgroup,
// TMA multicast of K/V across a GQA group in a cluster, a persistent grid.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace repro_torch::sm90;

constexpr int BQ = 128;        // query rows per block (64 per consumer)
constexpr int BK = 128;        // keys per kv tile
constexpr int STAGES = 2;      // kv ring depth
constexpr int THREADS = 384;   // producer + 2 consumer warpgroups
constexpr int BOX_BYTES = 128 * 128;  // one 64-column box of 128 rows
constexpr float NEG_INF = -1073741824.0f;  // -2^30, as the reference
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int NB = D / 64;                  // boxes per tile
  static constexpr int TILE = NB * BOX_BYTES;        // one q/k/v tile
  static constexpr int Q = 0;
  static constexpr int K = Q + TILE;                 // STAGES k tiles
  static constexpr int V = K + STAGES * TILE;        // STAGES v tiles
  static constexpr int BAR = V + STAGES * TILE;      // mbarriers
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES);
  static constexpr size_t ALLOC = BYTES + 1024;      // room to align
};

struct Params {
  __nv_bfloat16* o;
  int64_t o_sb, o_ss, o_sh;  // element strides of o
  int B, Sq, Skv, Hq, G, n_qt, causal, window, softcap_on;
  float scale_log2;  // D^-0.5 * log2 e
  float tanh_k;      // 2 log2 e * D^-0.5 / softcap
  float cap_log2;    // softcap * log2 e
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const Params p) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;             // [STAGES]
  uint64_t* empty = bars + 1 + STAGES;   // [STAGES]

  // block -> (query head, batch, q tile), the heaviest tiles first
  int bid = blockIdx.x;
  const int h = bid % p.Hq;
  bid /= p.Hq;
  const int b = bid % p.B;
  const int q0 = (p.n_qt - 1 - bid / p.B) * BQ;
  const int hk = h / p.G;

  // kv tiles that hold at least one visible key for some row of the tile
  const int q_end = min(q0 + BQ, p.Sq);
  const int k_end = p.causal ? min(p.Skv, q_end) : p.Skv;
  const int k_begin =
      p.window > 0 ? max(0, q0 - p.window + 1) / BK * BK : 0;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 4);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer --------------------------------------------------------
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      mbar_arrive_expect_tx(q_full, L::TILE);
#pragma unroll
      for (int nb = 0; nb < L::NB; ++nb)
        tma_load_4d(smem + L::Q + nb * BOX_BYTES, &qmap, q_full, nb * 64, h,
                    q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        const int k0 = k_begin + it * BK;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::TILE);
#pragma unroll
        for (int nb = 0; nb < L::NB; ++nb) {
          tma_load_4d(smem + L::K + s * L::TILE + nb * BOX_BYTES, &kmap,
                      &full[s], nb * 64, hk, k0, b);
          tma_load_4d(smem + L::V + s * L::TILE + nb * BOX_BYTES, &vmap,
                      &full[s], nb * 64, hk, k0, b);
        }
      }
    }
  } else {
    // ---- consumers -------------------------------------------------------
    setmaxnreg_inc<232>();
    constexpr int NO = D / 2;  // O accumulator registers per thread
    const int c = wg - 1;      // which 64 rows of the tile
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int qw = q0 + 64 * c;                    // first row of the 64
    const int row0 = qw + 16 * warp + lane / 4;    // and row0 + 8
    const int col0 = 2 * (lane % 4);
    const uint32_t q_addr = smem_addr(smem + L::Q) + c * 64 * 128;
    const uint32_t k_addr = smem_addr(smem + L::K);
    const uint32_t v_addr = smem_addr(smem + L::V);

    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      const int k0 = k_begin + it * BK;
      mbar_wait(&full[s], (it / STAGES) & 1);

      // S = Q K^T over D in steps of 16 (4 steps per 64-column box)
      float x[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
        wgmma_ss_m64n128k16<0>(
            x, desc_sw128(q_addr + off, 16, 1024),
            desc_sw128(k_addr + s * L::TILE + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);

      // scores in the log2 domain: x * log2 e
      if (p.softcap_on) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float r = rcp(1.f + ex2(x[i] * p.tanh_k));
          x[i] = fmaf(-2.f * p.cap_log2, r, p.cap_log2);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) x[i] *= p.scale_log2;
      }
      const bool all_visible =
          k0 + BK <= p.Skv && (!p.causal || k0 + BK - 1 <= qw) &&
          (p.window <= 0 || qw + 63 - k0 < p.window);
      if (!all_visible) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int row = row0 + 8 * ((i % 4) / 2);
          const int key = k0 + 8 * (i / 4) + col0 + (i % 2);
          const bool ok = key < p.Skv && (!p.causal || row >= key) &&
                          (p.window <= 0 || row - key < p.window);
          if (!ok) x[i] = NEG_INF;
        }
      }

      // online softmax: rows row0 (e = 0, 1) and row0 + 8 (e = 2, 3)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(x[4 * j], x[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(x[4 * j + 2], x[4 * j + 3]));
      }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = ex2(m[r] - mx[r]);
        m[r] = mx[r];
      }
      uint32_t pa[8][4];  // P as the A fragment of 8 k16 steps
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int r = (i % 4) / 2;
        const float p0 = ex2(x[i] - mx[r]), p1 = ex2(x[i + 1] - mx[r]);
        sum[r] += p0 + p1;
        pa[i / 8][(i % 8) / 2] = pack_bf16x2(p0, p1);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], corr[r], sum[r]);
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= corr[(i % 4) / 2];

      // O += P V over the tile's 128 keys in steps of 16
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv =
            desc_sw128(v_addr + s * L::TILE + kk * 16 * 128, BOX_BYTES, 1024);
        if constexpr (D == 128)
          wgmma_rs_m64n128k16<1>(o, pa[kk], dv, 1);
        else
          wgmma_rs_m64n64k16<1>(o, pa[kk], dv, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // O / max(l, 1e-30): the row sum across the quad first
    float den[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      den[r] = fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.Sq) continue;
      __nv_bfloat16* orow = p.o + b * p.o_sb + row * p.o_ss + h * p.o_sh;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + col0) = pack_bf16x2(
            o[4 * j + 2 * r] / den[r], o[4 * j + 2 * r + 1] / den[r]);
    }
  }
}

bool aligned16(const void* p, int64_t sb, int64_t ss, int64_t sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 &&
         ss % 8 == 0 && sh % 8 == 0;
}

// [B, S, H, D] bf16 -> tensor map with dims (D, H, S, B), 128-row boxes of
// 64 columns
bool make_map(CUtensorMap* map, const void* base, int64_t B, int64_t S,
              int64_t H, int64_t D, int64_t sb, int64_t ss, int64_t sh,
              int rows) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)S,
                            (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)sh * 2, (uint64_t)ss * 2,
                               (uint64_t)sb * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
  return repro_torch::make_map_bf16(map, base, 4, dims, strides, box);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t Sq, int64_t Skv, int64_t Hq, int64_t Hkv,
           const int64_t* st, int64_t causal, int64_t window, float scale,
           float softcap, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  if (!make_map(&qmap, q, B, Sq, Hq, D, st[0], st[1], st[2], BQ) ||
      !make_map(&kmap, k, B, Skv, Hkv, D, st[3], st[4], st[5], BK) ||
      !make_map(&vmap, v, B, Skv, Hkv, D, st[6], st[7], st[8], BK))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.o = (__nv_bfloat16*)o;
  p.o_sb = st[9];
  p.o_ss = st[10];
  p.o_sh = st[11];
  p.B = (int)B;
  p.Sq = (int)Sq;
  p.Skv = (int)Skv;
  p.Hq = (int)Hq;
  p.G = (int)(Hq / Hkv);
  p.n_qt = (int)((Sq + BQ - 1) / BQ);
  p.causal = (int)causal;
  p.window = (int)window;
  p.softcap_on = softcap != 0.f;
  p.scale_log2 = scale * LOG2E;
  p.tanh_k = softcap != 0.f ? 2.f * LOG2E * scale / softcap : 0.f;
  p.cap_log2 = softcap * LOG2E;
  const int64_t blocks = (int64_t)p.n_qt * B * Hq;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto kernel = flash_attention_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Layout<D>::ALLOC);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, THREADS, Layout<D>::ALLOC, stream>>>(
      qmap, kmap, vmap, p);
  return (int)cudaGetLastError();
}

}  // namespace

// The arguments of flash_attention_launch (flash_attention.cu); dtype must
// be 1 (bfloat16) and D 64 or 128.  Strides are in elements; q, k and v need
// a 16-byte aligned base and strides that are multiples of 8 elements (the
// wrapper copies them otherwise), o a contiguous last dimension.
extern "C" int flash_attention_sm90_launch(
    const void* q, const void* k, const void* v, void* o, int64_t B,
    int64_t Sq, int64_t Skv, int64_t Hq, int64_t Hkv, int64_t D,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
    int64_t o_ss, int64_t o_sh, int64_t causal, int64_t window, float scale,
    float softcap, int64_t dtype, void* stream) {
  const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  if (dtype != 1 || !aligned16(q, q_sb, q_ss, q_sh) ||
      !aligned16(k, k_sb, k_ss, k_sh) || !aligned16(v, v_sb, v_ss, v_sh))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return launch<64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, st, causal, window,
                      scale, softcap, s);
  if (D == 128)
    return launch<128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, st, causal, window,
                       scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}

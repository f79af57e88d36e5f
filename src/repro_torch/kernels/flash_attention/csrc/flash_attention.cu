// Flash-attention kernel: GQA attention with an online softmax, causal
// and sliding-window masks and a tanh softcap, for the LM serving path
// (prefill's attention in every layer).
//
// Replaces the Pallas kernel repro/kernels/flash_attention/kernel.py
// (_fa_kernel, launched by flash_attention_bhsd).  For every batch b,
// query head h (kv head h / G) and query position i:
//
//   s_ij = q_i . k_j * D^-0.5,  then softcap * tanh(s_ij / softcap)
//   s_ij = -2^30 unless (!causal || i >= j) && (window <= 0 || i - j < window)
//   o_i  = sum_j exp(s_ij - m_i) v_j / max(sum_j exp(s_ij - m_i), 1e-30)
//
// with the running max m, running sum l and an f32 accumulator carried
// across kv tiles, as the Pallas kernel carries them across its grid.
// Positions are implicit (0..Sq-1, 0..Skv-1).  Beyond the Pallas kernel,
// the ragged tails (Sq, Skv not multiples of a tile) are masked here, and
// Sq != Skv works.  Inputs are read in the JAX layout [B, S, H, D]
// through element strides (the last dimension contiguous), bf16 or f32;
// the output is q's dtype, all arithmetic f32.
//
// What bounds it on the H100: operations.  At the path's shapes
// (Gemma-2-27B prefill: B = 2, S = 8192, Hq = 32, Hkv = 16, D = 128,
// bf16) a global layer attends 33,558,528 (i, j) pairs per (b, h), i.e.
// 4 * D * B * Hq * pairs = 1.10 TFLOP, 1.11 ms at the 989 TFLOP/s of the
// bf16 tensor cores; a local layer (window 4096) 0.82 TFLOP, 0.83 ms.
// q, k, v and o are 403 MB, 0.12 ms at 3.35 TB/s, so the work is far
// above the ridge.
//
// Design (a simple first version): one block of 256 threads per
// (q tile of 64 rows, query head, batch), the heaviest causal tiles
// launched first.  The block stages its q tile once and each 64-row k/v
// tile in shared memory as f32 (rows padded by one float, so the column
// reads of the score product hit 32 banks), computes the 64 x 64 score
// tile as an outer-product micro-GEMM on CUDA cores (each thread a 4 x 4
// patch: rows 4*ty.., columns tx + 16*j), reduces row max and row sum
// with warp shuffles inside each 16-lane half, writes p over the spent
// k tile and accumulates p @ v into a 4 x D/16 register patch.  kv tiles
// that the causal or window mask empties entirely are skipped: they
// contribute exp(-2^30 - m) = 0 once a row has seen a visible key, so
// the result is the one the masking Pallas kernel gives.
//
// What it leaves on the table: the tensor cores.  CUDA-core f32 FMAs
// peak at 67 TFLOP/s, and the micro-GEMM reads two shared-memory words
// per FMA pair, so this runs tens of times slower than the bound.  The
// way to the bound is wgmma on bf16 tiles fed by TMA through a ring of
// shared-memory stages with warp specialisation (FlashAttention-3's
// shape); that is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per kv tile
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 score patch
constexpr float NEG_INF = -1073741824.0f;  // -2^30, as the reference

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {  // element strides of [B, S, H, D]; the D stride is 1
  int64_t b, s, h;
};

template <int D>
struct Smem {
  static constexpr int QLD = D + 1;  // q tile row pitch (floats)
  static constexpr int KLD = D + 1;  // k tile row pitch
  static constexpr int PLD = BK + 1; // p tile row pitch
  // the k tile's region is reused for p once the scores are computed
  static constexpr int KP = BK * KLD > BQ * PLD ? BK * KLD : BQ * PLD;
  static constexpr size_t bytes = (size_t)(BQ * QLD + KP + BK * D) * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, D <= 128 ? 2 : 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Skv, int G, Strides qs, Strides ks, Strides vs,
                       Strides os, int causal, int window, float scale,
                       float softcap) {
  using L = Smem<D>;
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][QLD]
  float* KPs = smem + BQ * L::QLD;   // [BK][KLD] k tile, then [BQ][PLD] p
  float* Vs = KPs + L::KP;           // [BK][D]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int q0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / G;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int p = q0 + r;
    Qs[r * L::QLD + d] = p < Sq ? to_f32(qb[p * qs.s + d]) : 0.f;
  }

  // kv tiles that hold at least one visible key for some row of the tile
  const int q_end = min(q0 + BQ, Sq);
  const int k_end = causal ? min(Skv, q_end) : Skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the q tile is written; the last p and v reads done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, d = e % D;
      const int p = k0 + r;
      const bool in = p < Skv;
      KPs[r * L::KLD + d] = in ? to_f32(kb[p * ks.s + d]) : 0.f;
      Vs[r * D + d] = in ? to_f32(vb[p * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * L::QLD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = KPs[(tx + 16 * j) * L::KLD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

    float rmax[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        bool ok = kp < Skv;
        if (causal) ok = ok && qp >= kp;
        if (window > 0) ok = ok && qp - kp < window;
        s[i][j] = ok ? x : NEG_INF;
      }
      rmax[i] = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], off));
    }
    __syncthreads();  // every read of the k tile is done: p goes there

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mn = fmaxf(m[i], rmax[i]);
      const float corr = expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        ps += p;
        KPs[(ty * 4 + i) * L::PLD + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * corr + ps;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = KPs[(ty * 4 + i) * L::PLD + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + b * os.b + qp * os.s + h * os.h;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t Sq, int64_t Skv, int64_t Hq, int64_t Hkv, Strides qs,
           Strides ks, Strides vs, Strides os, int64_t causal,
           int64_t window, float scale, float softcap, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)Hq, (unsigned)B);
  kernel<<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (int)Sq, (int)Skv,
      (int)(Hq / Hkv), qs, ks, vs, os, (int)causal, (int)window, scale,
      softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int64_t D, const void* q, const void* k, const void* v, void* o,
             int64_t B, int64_t Sq, int64_t Skv, int64_t Hq, int64_t Hkv,
             Strides qs, Strides ks, Strides vs, Strides os, int64_t causal,
             int64_t window, float scale, float softcap,
             cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os,
                           causal, window, scale, softcap, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os,
                           causal, window, scale, softcap, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os,
                           causal, window, scale, softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os,
                            causal, window, scale, softcap, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os,
                            causal, window, scale, softcap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int64_t B,
    int64_t Sq, int64_t Skv, int64_t Hq, int64_t Hkv, int64_t D,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
    int64_t o_ss, int64_t o_sh, int64_t causal, int64_t window, float scale,
    float softcap, int64_t dtype, void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, o, B, Sq, Skv, Hq, Hkv, qs, ks, vs,
                           os, causal, window, scale, softcap, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, B, Sq, Skv, Hq, Hkv, qs,
                                   ks, vs, os, causal, window, scale,
                                   softcap, st);
  return (int)cudaErrorInvalidValue;
}

// Flash-attention kernel on the CUDA cores: GQA attention with an online
// softmax, causal and sliding-window masks and a tanh softcap, for f32
// inputs at every head dim and bf16 at head dims 16, 32 and 256 (bf16 at
// 64 and 128 goes to flash_attention_sm90.cu; ../ops.py dispatches).
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
// through element strides (the last dimension contiguous, rows 16-byte
// aligned: the wrapper copies a view that is not), bf16 or f32; the
// output is q's dtype, all arithmetic true f32 FMAs (no TF32: the
// reference multiplies f32 by f32 in f32).
//
// What bounds it on the H100: operations, on the CUDA cores.  At the f32
// check's shapes (2 x 1032 tokens, 16 / 16 heads of 128, causal) the
// masks let 533,028 (i, j) pairs through per head: 4 * D * pairs * B * H
// = 8.73 GFLOP, 0.1303 ms at 67 TFLOP/s (f32 outside the tensor cores);
// its 67.6 MB of q, k, v and o take 0.0202 ms at 3.35 TB/s.  Under the
// FMAs lies the shared-memory pipe: a warp's float4 read costs it about
// twice as long when a quarter-warp reads four or more distinct chunks
// as when it reads one or two (scripts/lds128_throughput.py), and the
// score product's 12 float4 reads a 4-wide d chunk keep it about as busy
// as its 128 FMAs keep the FMA units.
//
// Design.  One block of 128 threads (8 row groups x 16 column groups) per
// (q tile of BQ rows, query head, batch); the grid is one dimension with
// the q tile slowest, so the heaviest causal tiles of every head start
// first, and the query heads of one kv head run side by side (their K and
// V tiles meet in L2).  q, k and v sit in shared memory as f32 rows of D,
// each 16-byte chunk of a row XOR-swizzled by the row's low bits, so a
// float4 read of 16 neighbouring keys (or of one v row) touches every
// bank once.  Per kv tile of BK keys:
//   * scores: thread (rg, cg) owns rows rg + 8 i (BQ / 8 of them) and keys
//     cg + 16 j (BK / 16): per 4-wide d chunk it reads its rows' and keys'
//     float4s and does 4 x (BQ / 8) x (BK / 16) FMAs, 128 at D <= 128
//     (0.375 words an FMA; a warp's two row groups read the same key
//     chunks and broadcast their row chunks);
//   * softmax in base 2: log2(e) is folded into the scale (the softcap's
//     tanh stays in natural units, its output scaled by log2(e)), exp2f
//     per score, the row max over the 16 lanes of a row group by
//     shuffles, the row sum kept per thread and summed once at the end;
//   * p is written transposed ([key][row]) and P.V accumulates into a
//     (BQ / 8) x (D / 16) register patch: per key two float4 of p and
//     D / 64 float4 of v for 8 x D / 16 FMAs (0.25 words an FMA at
//     D = 128).
// K and V each have one buffer, filled a half-tile ahead: K(t+1) streams
// in by cp.async while P.V(t) runs, V(t) while the scores of tile t run
// (bf16: loaded into registers at the same points and converted into the
// buffer after the math they overlap).  Three barriers per tile.  A ring
// of two K and two V tiles would need 64 KB more at D = 128 and leave one
// block an SM.  Tiles the mask empties for every row are skipped; the
// compare-and-select of the masks runs only on tiles that cross a mask
// edge; a q tile of at most 8 rows (the ragged tail of Sq: 1032 = 16 x 64
// + 8) runs with one row a thread, an eighth of a full tile's work.
// Tiles: D <= 128: BQ = BK = 64, 115,712 bytes of shared memory at
// D = 128 (two blocks on an SM, the most its 228 KB hold); D = 256:
// BQ = BK = 32 (a 4 x 16 output patch, 102,912 bytes).  At the f32 check:
// 2 x 16 x 17 = 544 blocks, two resident on each of 132 SMs.
//
// What it leaves on the table: the causal diagonal tiles compute their
// masked half (at 1032 tokens the computed tiles hold 94% useful pairs),
// and the 8 x 4 score patch, whose reads keep the shared-memory pipe as
// busy as the FMAs; an 8 x 8 patch (BK = 128) needs 195 KB and spills.
//
// Measured (chip_smoke.py, H100 80GB HBM3 at 700 W, two runs): the f32
// check 0.2796 ms in both, 47% of its bound (the earlier design: 0.5781;
// scaled_dot_product_attention in f32: 0.3131 / 0.3125).  ptxas: 254
// registers and 56 bytes of spill stores at D = 128 f32, none at 16-64.
//
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"

namespace {

namespace cpa = repro_torch::cp_async;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;  // 8 row groups x 16 column groups
constexpr float NEG_INF = -1073741824.0f;  // -2^30, as the reference
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int BQ = D <= 128 ? 64 : 32;  // query rows per block
  static constexpr int BK = BQ;                  // keys per kv tile
  static constexpr int RM = BQ / 8;              // rows a thread: rg + 8 i
  static constexpr int SC = BK / 16;             // keys a thread: cg + 16 j
  static constexpr int CH = D / 4;               // 16-byte f32 chunks a row
  static constexpr int SW = (CH < 8 ? CH : 8) - 1;  // chunk swizzle mask
  static constexpr int DV = D / 16;              // output columns a thread
  static constexpr int VW = DV < 4 ? DV : 4;     // their vector width
  static constexpr int VC = DV / VW;             // vectors a thread
  static constexpr int PP = BQ + 4;              // p row pitch ([key][row])
  static constexpr int QF = BQ * D, KF = BK * D, PF = BK * PP;
  static constexpr size_t bytes = (size_t)(QF + 2 * KF + PF) * 4;
};

// Float offset of chunk c (4 floats) of row r in a swizzled [rows][D] tile.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & Cfg<D>::SW)) << 2);
}

struct Strides {  // element strides of [B, S, H, D]; the D stride is 1
  int64_t b, s, h;
};

// A tile of R rows (positions p0.. of src, zeros from lim on) into a
// swizzled f32 tile: f32 by cp.async, bf16 through registers.
template <int D, int R>
struct Tile {
  static constexpr int NF = R * (D / 4) / THREADS;  // f32 chunks a thread
  static constexpr int NB = R * (D / 8) / THREADS;  // bf16 chunks a thread

  static __device__ __forceinline__ void async(float* dst, const float* src,
                                               int64_t ss, int p0,
                                               int lim) {
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int r = e / (D / 4), c = e % (D / 4);
      const bool ok = p0 + r < lim;
      cpa::copy16(dst + swz<D>(r, c),
                  ok ? src + (int64_t)(p0 + r) * ss + c * 4 : src,
                  ok ? 16 : 0);
    }
  }

  static __device__ __forceinline__ void load(uint4 (&reg)[NB],
                                              const bf16* src, int64_t ss,
                                              int p0, int lim) {
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int r = e / (D / 8), c = e % (D / 8);
      reg[i] = p0 + r < lim
                   ? __ldg(reinterpret_cast<const uint4*>(
                         src + (int64_t)(p0 + r) * ss + c * 8))
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  static __device__ __forceinline__ void store(float* dst,
                                               const uint4 (&reg)[NB]) {
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int r = e / (D / 8), c = e % (D / 8);
      const __nv_bfloat162* h =
          reinterpret_cast<const __nv_bfloat162*>(&reg[i]);
      const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
      const float2 x = __bfloat1622float2(h[2]), y = __bfloat1622float2(h[3]);
      *reinterpret_cast<float4*>(dst + swz<D>(r, 2 * c)) =
          make_float4(a.x, a.y, b.x, b.y);
      *reinterpret_cast<float4*>(dst + swz<D>(r, 2 * c + 1)) =
          make_float4(x.x, x.y, y.x, y.y);
    }
  }
};

// n consecutive floats of shared memory into dst[0..n)
template <int N>
__device__ __forceinline__ void load_vec(float* dst, const float* p) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    dst[0] = t.x;
    dst[1] = t.y;
    dst[2] = t.z;
    dst[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    dst[0] = t.x;
    dst[1] = t.y;
  } else {
    dst[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void store_out(float* p, const float* v) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}
template <int N>
__device__ __forceinline__ void store_out(bf16* p, const float* v) {
  if constexpr (N == 1) {
    *p = __float2bfloat16(v[0]);
  } else {
#pragma unroll
    for (int e = 0; e < N; e += 2)
      *reinterpret_cast<__nv_bfloat162*>(p + e) =
          __floats2bfloat162_rn(v[e], v[e + 1]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Skv, int Hq, int HB, int G, int ntiles, Strides qs,
                       Strides ks, Strides vs, Strides os, int causal,
                       int window, float scale2, float cap_in, float cap2) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, SC = C::SC;
  constexpr int VW = C::VW, VC = C::VC, SW = C::SW;
  constexpr bool F32 = sizeof(T) == 4;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;         // [BQ][D] swizzled
  float* Ks = Qs + C::QF;   // [BK][D] swizzled
  float* Vs = Ks + C::KF;   // [BK][D] swizzled
  float* Ps = Vs + C::KF;   // [BK][PP]: p transposed, row rg + 8 i at rg*RM + i

  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;  // row group, column group
  // q tile slowest (heaviest first), then batch, query head fastest
  const int hb = (int)(blockIdx.x % (unsigned)HB);
  const int q0 = (ntiles - 1 - (int)(blockIdx.x / (unsigned)HB)) * BQ;
  const int h = hb % Hq, b = hb / Hq;
  const int hk = h / G;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  // kv tiles that hold at least one visible key for some row of the tile
  const int q_end = min(q0 + BQ, Sq);
  const int k_end = causal ? min(Skv, q_end) : Skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;

  using QT = Tile<D, BQ>;
  using KT = Tile<D, BK>;
  if constexpr (F32) {
    QT::async(Qs, reinterpret_cast<const float*>(qb), qs.s, q0, Sq);
    KT::async(Ks, reinterpret_cast<const float*>(kb), ks.s, k_begin, Skv);
    cpa::commit();
  } else {
    uint4 qreg[QT::NB], kreg[KT::NB];
    QT::load(qreg, reinterpret_cast<const bf16*>(qb), qs.s, q0, Sq);
    QT::store(Qs, qreg);
    KT::load(kreg, reinterpret_cast<const bf16*>(kb), ks.s, k_begin, Skv);
    KT::store(Ks, kreg);
  }

  // rows rg + 8 i, i < RM: all BQ / 8 of them, or one where the tile
  // holds at most 8 rows (the ragged tail of Sq; the f32 check's 1032 =
  // 16 x 64 + 8), so the tail does an eighth of a tile's work
  auto attend = [&](auto rows) {
    constexpr int RM = decltype(rows)::value;
    constexpr int PV = RM < 4 ? RM : 4;  // p read width
    float m[RM], l[RM], acc[RM][C::DV];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.f;
#pragma unroll
      for (int j = 0; j < C::DV; ++j) acc[i][j] = 0.f;
    }
    const int qsw = rg & SW, ksw = cg & SW;

    for (int k0 = k_begin; k0 < k_end; k0 += BK) {
      const int next = k0 + BK;
      cpa::wait<0>();
      __syncthreads();  // K(k0) landed; every read of V and P of k0 - BK done
      uint4 vreg[F32 ? 1 : KT::NB];
      if constexpr (F32) {
        KT::async(Vs, reinterpret_cast<const float*>(vb), vs.s, k0, Skv);
        cpa::commit();
      } else {
        KT::load(vreg, reinterpret_cast<const bf16*>(vb), vs.s, k0, Skv);
      }

      float s[RM][SC];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int c = 0; c < D / 4; ++c) {
        float4 kv[SC];
#pragma unroll
        for (int j = 0; j < SC; ++j)
          kv[j] = *reinterpret_cast<const float4*>(
              Ks + (cg + 16 * j) * D + ((c ^ ksw) << 2));
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(
              Qs + (rg + 8 * i) * D + ((c ^ qsw) << 2));
#pragma unroll
          for (int j = 0; j < SC; ++j) {
            s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
          }
        }
      }

      // scale (base 2) or softcap, then the masks on the tiles that cross
      // a mask edge (both branches uniform over the block)
      if (cap_in != 0.f) {
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < SC; ++j) s[i][j] = cap2 * tanhf(s[i][j] * cap_in);
      } else {
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < SC; ++j) s[i][j] *= scale2;
      }
      if (next > Skv || (causal && next - 1 > q0) ||
          (window > 0 && q0 + BQ - 1 - k0 >= window)) {
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int qp = q0 + rg + 8 * i;
#pragma unroll
          for (int j = 0; j < SC; ++j) {
            const int kp = k0 + cg + 16 * j;
            bool ok = kp < Skv;
            if (causal) ok = ok && qp >= kp;
            if (window > 0) ok = ok && qp - kp < window;
            s[i][j] = ok ? s[i][j] : NEG_INF;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        float mx = s[i][0];
#pragma unroll
        for (int j = 1; j < SC; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx,
                                         off));
        const float mn = fmaxf(m[i], mx);
        const float corr = exp2f(m[i] - mn);
        m[i] = mn;
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          s[i][j] = exp2f(s[i][j] - mn);
          ps += s[i][j];
        }
        l[i] = l[i] * corr + ps;
#pragma unroll
        for (int j = 0; j < C::DV; ++j) acc[i][j] *= corr;
      }

      __syncthreads();  // every read of K(k0) done: K(next) may land there
      if constexpr (F32) {
        if (next < k_end)
          KT::async(Ks, reinterpret_cast<const float*>(kb), ks.s, next, Skv);
        cpa::commit();
      }
      uint4 kreg[F32 ? 1 : KT::NB];
      if constexpr (!F32) {
        if (next < k_end)
          KT::load(kreg, reinterpret_cast<const bf16*>(kb), ks.s, next, Skv);
      }
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        float* dst = Ps + (cg + 16 * j) * C::PP + rg * RM;
        if constexpr (RM % 4 == 0) {
#pragma unroll
          for (int i = 0; i < RM; i += 4)
            *reinterpret_cast<float4*>(dst + i) =
                make_float4(s[i][j], s[i + 1][j], s[i + 2][j], s[i + 3][j]);
        } else {
#pragma unroll
          for (int i = 0; i < RM; ++i) dst[i] = s[i][j];
        }
      }
      if constexpr (F32) {
        cpa::wait<1>();  // V(k0); K(next) may still be in flight
      } else {
        KT::store(Vs, vreg);
      }
      __syncthreads();  // p and V(k0) visible

#pragma unroll 8
      for (int c = 0; c < BK; ++c) {
        float p[RM], vv[C::DV];
#pragma unroll
        for (int i = 0; i < RM; i += PV)
          load_vec<PV>(p + i, Ps + c * C::PP + rg * RM + i);
#pragma unroll
        for (int jj = 0; jj < VC; ++jj) {
          const int col = jj * 16 * VW + cg * VW;
          load_vec<VW>(vv + jj * VW,
                       Vs + c * D + (((col >> 2) ^ (c & SW)) << 2)
                           + (col & 3));
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < C::DV; ++j)
            acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
      }
      if constexpr (!F32) {
        if (next < k_end) KT::store(Ks, kreg);
      }
    }
    cpa::wait<0>();  // no copy outlives the block (a block with no kv tile)

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float den = l[i];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        den += __shfl_xor_sync(0xffffffffu, den,
                               off);
      const int qp = q0 + rg + 8 * i;
      if (qp >= Sq) continue;
      den = fmaxf(den, 1e-30f);
      T* orow = o + b * os.b + qp * os.s + h * os.h;
#pragma unroll
      for (int jj = 0; jj < VC; ++jj) {
        float out[VW];
#pragma unroll
        for (int e = 0; e < VW; ++e) out[e] = acc[i][jj * VW + e] / den;
        store_out<VW>(orow + jj * 16 * VW + cg * VW, out);
      }
    }
  };
  if (q_end - q0 <= 8)
    attend(std::integral_constant<int, 1>{});
  else
    attend(std::integral_constant<int, C::RM>{});
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t Sq, int64_t Skv, int64_t Hq, int64_t Hkv, Strides qs,
           Strides ks, Strides vs, Strides os, int64_t causal,
           int64_t window, float scale, float softcap, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  const size_t smem = Cfg<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int64_t ntiles = (Sq + Cfg<D>::BQ - 1) / Cfg<D>::BQ;
  const int64_t blocks = ntiles * Hq * B;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  const float scale2 = scale * LOG2E;
  const float cap_in = softcap != 0.f ? scale / softcap : 0.f;
  const float cap2 = softcap * LOG2E;
  kernel<<<dim3((unsigned)blocks), THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (int)Sq, (int)Skv,
      (int)Hq, (int)(Hq * B), (int)(Hq / Hkv), (int)ntiles, qs, ks, vs, os,
      (int)causal, (int)window, scale2, cap_in, cap2);
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

// Hopper building blocks for the port's kernels: TMA tensor loads that
// complete on an mbarrier, the mbarrier ring's operations, the async-proxy
// fence, wgmma (bf16 in, f32 accumulators; m64n64k16 and m64n128k16 with
// A from shared memory or from registers, m64n256k16 with A from shared
// memory) with its fence / commit / wait, the 64-bit shared-memory matrix
// descriptor for the 128-byte swizzle, and setmaxnreg.  All of it is
// inline PTX for sm_90a; the host side encodes a tensor map through
// libcuda's cuTensorMapEncodeTiled, whose address the runtime looks up at
// first use, so a kernel library needs no -lcuda.
//
// Used by flash_attention/csrc/flash_attention_sm90.cu (4-D maps, Q.K^T
// with both operands K-major, P.V with A from registers) and by
// segment_matmul/csrc/segment_matmul_sm90.cu (3-D maps, x K-major times w
// MN-major, both from shared memory).
//
// Layout convention: a tile is loaded by TMA with CU_TENSOR_MAP_SWIZZLE_128B
// in boxes of 64 bf16 columns (128 bytes, the widest box that swizzle
// allows) by R rows, one box after the other, each at a 1024-byte aligned
// address.  Inside a box, 8 rows of 128 bytes form one 1024-byte swizzle
// atom.  wgmma reads such a box:
//   * K-major (the reduction dimension contiguous, e.g. Q or K with D
//     contiguous): SBO = 1024 bytes between 8-row groups, LBO unused; the
//     k-th 16-column step starts 32 * k bytes into the box;
//   * MN-major (the output dimension contiguous, e.g. V with D
//     contiguous, read with the transpose bit): SBO = 1024 bytes between
//     8-row (8 k) groups, LBO = the byte distance between two boxes (the
//     next 64 output columns); the k-th 16-row step starts 2048 * k bytes
//     into the box.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarrier ---------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the other threads and to TMA.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrives once and adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Spins until the phase of parity `parity` has completed.  A fresh barrier
// is in phase 0, so a wait on parity 1 passes at once (a ring's producer
// starts there: every stage is empty).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy (TMA, wgmma) accesses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- TMA ----------------------------------------------------------------------
// Loads the box at coordinates (c0 innermost .. c2) of a 3-D tensor map into
// shared memory at `dst`; completes `bytes` of transactions on `bar`.
// Elements past the tensor's extent arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Loads the box at coordinates (c0 innermost .. c3) of a 4-D tensor map into
// shared memory at `dst`; completes `bytes` of transactions on `bar`.
// Elements past the tensor's extent arrive as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// -- register budget ------------------------------------------------------------
template <int Regs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Regs));
}

template <int Regs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Regs));
}

// -- wgmma ------------------------------------------------------------------------
// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1 in bits
// 62-63); addresses and offsets in bytes, encoded in 16-byte units.  The
// tile's swizzle atoms must sit at 1024-byte aligned addresses (base offset
// 0); a start address inside an atom (a k step of a K-major operand) is
// fine, the hardware swizzles the final address.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

// Before the first wgmma that reads registers or accumulators this thread
// wrote.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers at this point of the program.  After wgmma_wait: the
// compiler sees the wgmma asm statement as the accumulators' writer, so
// without this it could read them before the wait returns.  Before
// wgmma_fence: the registers a wgmma reads are written before the fence.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define REPRO_WGMMA_D8(d, i)                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define REPRO_WGMMA_D32(d)                                                \
  REPRO_WGMMA_D8(d, 0), REPRO_WGMMA_D8(d, 8), REPRO_WGMMA_D8(d, 16),      \
      REPRO_WGMMA_D8(d, 24)
#define REPRO_WGMMA_D64(d)                                                \
  REPRO_WGMMA_D8(d, 0), REPRO_WGMMA_D8(d, 8), REPRO_WGMMA_D8(d, 16),      \
      REPRO_WGMMA_D8(d, 24), REPRO_WGMMA_D8(d, 32), REPRO_WGMMA_D8(d, 40), \
      REPRO_WGMMA_D8(d, 48), REPRO_WGMMA_D8(d, 56)
#define REPRO_WGMMA_D128(d)                                               \
  REPRO_WGMMA_D8(d, 0), REPRO_WGMMA_D8(d, 8), REPRO_WGMMA_D8(d, 16),      \
      REPRO_WGMMA_D8(d, 24), REPRO_WGMMA_D8(d, 32), REPRO_WGMMA_D8(d, 40), \
      REPRO_WGMMA_D8(d, 48), REPRO_WGMMA_D8(d, 56), REPRO_WGMMA_D8(d, 64), \
      REPRO_WGMMA_D8(d, 72), REPRO_WGMMA_D8(d, 80), REPRO_WGMMA_D8(d, 88), \
      REPRO_WGMMA_D8(d, 96), REPRO_WGMMA_D8(d, 104),                      \
      REPRO_WGMMA_D8(d, 112), REPRO_WGMMA_D8(d, 120)

// Accumulator layout (every shape here): thread t of the warpgroup holds,
// for j = 0 .. N/8 - 1, d[4j + e] at row 16 * (t / 32) + (t % 32) / 4 +
// 8 * (e / 2) and column 8j + 2 * (t % 4) + e % 2.  scale_d = 0 overwrites
// d, 1 accumulates.  TransB = 1 reads B MN-major (N contiguous).

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory.
template <int TransB>
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : REPRO_WGMMA_D32(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory.
template <int TransB>
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, %67;\n}\n"
      : REPRO_WGMMA_D64(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

// D[64 x 256] (+)= A[64 x 16] B[16 x 256], A and B from shared memory.
template <int TransB>
__device__ __forceinline__ void wgmma_ss_m64n256k16(float (&d)[128],
                                                  uint64_t desc_a,
                                                  uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16\n"
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73,"
      " %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      " %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97,"
      " %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108,"
      " %109, %110, %111, %112, %113, %114, %115, %116, %117, %118,"
      " %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}"
      ", %128, %129, p, 1, 1, 0, %131;\n}\n"
      : REPRO_WGMMA_D128(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A from registers (the
// accumulator layout of a 64-row tile packed into bf16x2), B from shared
// memory.
template <int TransB>
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : REPRO_WGMMA_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d), "n"(TransB));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A from registers (the
// accumulator layout of a 64-row tile packed into bf16x2), B from shared
// memory.
template <int TransB>
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : REPRO_WGMMA_D64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d), "n"(TransB));
}

#undef REPRO_WGMMA_D8
#undef REPRO_WGMMA_D32
#undef REPRO_WGMMA_D64
#undef REPRO_WGMMA_D128

// Two f32 into one bf16x2 register (lo in the low half), round to nearest.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

}  // namespace sm90

// -- host: tensor maps --------------------------------------------------------
// cuTensorMapEncodeTiled, looked up through the runtime at first use.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor map of rank 3 or 4 with 128-byte swizzle; dims and box
// innermost first, strides in bytes of dims 1..rank-1 (dim 0 is
// contiguous).  Needs a 16-byte aligned base and strides that are
// multiples of 16.  Returns false when libcuda refuses it.
inline bool make_map_bf16(CUtensorMap* map, const void* base, int rank,
                          const uint64_t* dims, const uint64_t* strides,
                          const uint32_t* box) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        (cuuint32_t)rank, const_cast<void*>(base), dims,
                        strides, box, elem_strides,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

}  // namespace repro_torch

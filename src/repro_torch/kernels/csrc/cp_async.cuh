// cp.async (sm_80 and later): 16-byte copies from global to shared memory
// that run beside the math, in commit groups the thread waits on.  Used by
// the CUDA-core kernels: flash_attention/csrc/flash_attention.cu (its K and
// V tiles) and segment_matmul/csrc/segment_matmul.cu (the f32 kernel's w
// tiles).
#pragma once
#include <stdint.h>

namespace repro_torch {
namespace cp_async {

// Copy 16 bytes from gmem to smem; with src_bytes 0 the 16 bytes are
// zero-filled and gmem is not read.  Both addresses 16-byte aligned.
__device__ __forceinline__ void copy16(void* smem, const void* gmem,
                                       int src_bytes) {
  const uint32_t s =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace cp_async
}  // namespace repro_torch

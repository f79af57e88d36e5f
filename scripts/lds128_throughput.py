#!/usr/bin/env python3
"""Throughput of 128-bit shared-memory loads by address pattern, on the card.

    python3 scripts/lds128_throughput.py      # needs a CUDA card and nvcc

The CUDA-core kernels (``flash_attention.cu``, ``segment_matmul.cu``'s
f32 kernel) read their operands as ``float4`` from shared memory; how many
distinct 16-byte chunks each quarter-warp reads sets what one such load
costs.  For each pattern the script times blocks of 8 warps that do
nothing but these loads (and the adds that keep them live) and prints the
warp-wide loads an SM completes per nanosecond, beside the card's name
and power limit.  Patterns: every lane one chunk (1), one chunk a
quarter-warp (lane / 8), two a quarter-warp (lane / 4), four a
quarter-warp (the same four in every quarter: lane % 4), eight a
quarter-warp (lane % 8), and 32 (lane).
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PATTERNS = {"1 chunk": 0, "1 a quarter-warp": 1, "2 a quarter-warp": 2,
            "4 a quarter-warp": 3, "8 a quarter-warp": 4, "32": 5}
SOURCE = r"""
#include <cuda_runtime.h>
template <int P>
__global__ void __launch_bounds__(256) lds(float* out, int iters) {
  __shared__ __align__(16) float4 s[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    s[i] = make_float4(i, 1, 2, 3);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int idx = P == 0 ? 0 : P == 1 ? lane >> 3 : P == 2 ? lane >> 2
                : P == 3 ? lane & 3 : P == 4 ? lane & 7 : lane;
  float4 acc = make_float4(0, 0, 0, 0);
  for (int it = 0; it < iters; ++it) {
    const int base = (it & 7) * 32 + idx;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float4 v = s[(base + u * 128) & 1023];
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
  }
  if (acc.x == -1.f) out[0] = acc.y + acc.z + acc.w;
}
extern "C" int lds_launch(int p, void* out, int iters, int blocks,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* o = (float*)out;
  switch (p) {
    case 0: lds<0><<<blocks, 256, 0, st>>>(o, iters); break;
    case 1: lds<1><<<blocks, 256, 0, st>>>(o, iters); break;
    case 2: lds<2><<<blocks, 256, 0, st>>>(o, iters); break;
    case 3: lds<3><<<blocks, 256, 0, st>>>(o, iters); break;
    case 4: lds<4><<<blocks, 256, 0, st>>>(o, iters); break;
    default: lds<5><<<blocks, 256, 0, st>>>(o, iters); break;
  }
  return (int)cudaGetLastError();
}
"""


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("lds128_throughput: no CUDA device")
    build = ROOT / "build" / "lds128"
    build.mkdir(parents=True, exist_ok=True)
    (build / "lds128.cu").write_text(SOURCE)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(build / "lds128.so"),
                    str(build / "lds128.cu")], check=True)
    lib = ctypes.CDLL(str(build / "lds128.so"))
    lib.lds_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_int, ctypes.c_void_p]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    iters, blocks = 4096, sms * 8
    print(card)
    for name, p in PATTERNS.items():
        lib.lds_launch(p, out.data_ptr(), iters, blocks, stream)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = lib.lds_launch(p, out.data_ptr(), iters, blocks, stream)
        end.record()
        torch.cuda.synchronize()
        if rc:
            raise SystemExit(f"lds128_throughput: launch failed ({rc})")
        ms = start.elapsed_time(end)
        loads = blocks * 8 * iters * 8          # warp-wide loads
        print(f"distinct 16-byte chunks: {name:>17}: {ms:.3f} ms, "
              f"{loads / sms / (ms * 1e6):.3f} warp loads per SM per ns")


if __name__ == "__main__":
    main()

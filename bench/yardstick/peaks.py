"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9
F32_OPS_PER_S = 67e12          # CUDA cores, outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # tensor cores, dense

"""Grouped GEMM: the MoE expert products of the LM path."""

"""Tree-sampler kernel: all of Alg. 3 per sample."""

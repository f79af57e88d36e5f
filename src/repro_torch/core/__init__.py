"""The TIMEST estimator core: graph, trees, weight DP, sampler, counts."""

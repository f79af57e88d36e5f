"""The TIMEST estimator core: graph, trees, weight DP, sampler, counts,
the tree-cohort engine and batch planner, and the numpy oracles (exact
counts, baselines)."""

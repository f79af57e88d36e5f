"""Interval-weight kernel: the Claim 4.9 dep-sum of the weight DP."""

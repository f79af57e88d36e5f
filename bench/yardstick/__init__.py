"""What the benchmark measures with: the card's published peaks, the
bytes a kernel's function must move, and the reading of a profiled
slice."""

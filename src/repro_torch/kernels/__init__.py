"""Hand-written CUDA kernels for Hopper, each with its plain torch twin."""
from __future__ import annotations


def tma_ready(x) -> bool:
    """True when TMA can read the tensor ``x`` as it is: a 16-byte aligned
    base, a contiguous last dimension and the other strides multiples of
    16 bytes.  The sm90 kernels' wrappers copy a tensor that is not."""
    step = 16 // x.element_size()
    return (x.data_ptr() % 16 == 0 and x.stride(-1) == 1
            and all(s > 0 and s % step == 0 for s in x.stride()[:-1]))

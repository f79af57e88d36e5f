"""Wrapper of the interval-weight kernel (``csrc/interval_weight.cu``).

``interval_weight`` takes the plain torch version (``ref.py``) for CPU
tensors and launches the CUDA kernel for CUDA tensors; on any other
device, or on inputs the kernel does not take, it raises.
``interval_weight.launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ...core.bisect import bisect_iters
from .ref import interval_weight_ref

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]


def _check_inputs(csr_t, ps_own, ps_prev, queries):
    m = csr_t.shape[0]
    dev = csr_t.device
    for name, x, n in (("csr_t", csr_t, m), ("ps_own", ps_own, m + 1),
                       ("ps_prev", ps_prev, m + 1)):
        if x.dtype != torch.int64 or x.dim() != 1 or x.shape[0] != n:
            raise ValueError(f"interval_weight: {name} must be int64 [{n}], "
                             f"got {x.dtype} {tuple(x.shape)}")
    Q = queries[0].shape
    for x in (csr_t, ps_own, ps_prev, *queries):
        if x.device != dev:
            raise ValueError("interval_weight: inputs on different devices")
    for x in queries:
        if x.dtype != torch.int64 or x.shape != Q or x.dim() != 1:
            raise ValueError("interval_weight: queries must be int64 [Q] "
                             "of one length")


def interval_weight(csr_t, ps_own, ps_prev, p0, p1, tlo, thi, brk):
    """Batched two-piece interval weight sums (see the kernel source)."""
    queries = (p0, p1, tlo, thi, brk)
    _check_inputs(csr_t, ps_own, ps_prev, queries)
    device = csr_t.device
    if device.type == "cpu":
        return interval_weight_ref(csr_t, ps_own, ps_prev, *queries)
    if device.type != "cuda":
        raise ValueError(f"interval_weight: no kernel for device {device}")
    args = [x.contiguous() for x in (csr_t, ps_own, ps_prev, *queries)]
    Q = p0.shape[0]
    out = torch.empty(Q, dtype=torch.int64, device=device)
    if Q == 0:
        return out
    lib = _build.library("interval_weight")
    fn = lib.interval_weight_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    m = csr_t.shape[0]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*[x.data_ptr() for x in args], out.data_ptr(), m, Q,
                bisect_iters(m), stream)
    _build.check(rc, "interval_weight")
    interval_weight.launches += 1
    return out


interval_weight.launches = 0

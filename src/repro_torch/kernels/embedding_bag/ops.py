"""Wrapper of the EmbeddingBag kernel (``csrc/embedding_bag.cu``).

``embedding_bag(table, idx, weights=None)`` computes what the JAX
package's ``embedding_bag`` computes: per bag the weighted sum of the
table rows its slots name, with ``-1`` slots as padding (weight 0) and
missing weights as ones; the sum is in f32 and the output in the
table's dtype (``out_dtype=torch.float32`` on a bf16 table: the f32
sums, unrounded, for partial bags that are added before one rounding).
The kernel applies those slot rules itself, so the ids (int32 or int64)
and weights go to it as they are.  It takes the plain
torch version (``ref.py``) for CPU tensors and launches the CUDA kernel
for CUDA tensors; on any other device, or on inputs the kernel does not
take, it raises.  ``embedding_bag.launches`` counts the kernel launches.

On meta tensors inside ``roofline.cost.counting()`` (the dry run) it
launches nothing: it returns an empty output of the kernel's shape and
dtype and reports the kernel's work (``_meta``); outside that region a
meta tensor raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import embedding_bag_ref

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]


def _check_inputs(table, idx, weights, out_dtype):
    if table.dim() != 2 or idx.dim() != 2:
        raise ValueError("embedding_bag: table must be [V, d] and idx "
                         f"[B, bag], got {tuple(table.shape)}, "
                         f"{tuple(idx.shape)}")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("embedding_bag: table must be float32 or bfloat16, "
                         f"got {table.dtype}")
    if out_dtype not in (table.dtype, torch.float32):
        raise ValueError(f"embedding_bag: out_dtype must be the table's "
                         f"({table.dtype}) or float32, got {out_dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"embedding_bag: idx must be int32 or int64, got "
                         f"{idx.dtype}")
    if table.shape[0] == 0 and idx.numel():
        raise ValueError("embedding_bag: empty table")
    devices = {table.device, idx.device}
    if weights is not None:
        if weights.shape != idx.shape or not weights.is_floating_point():
            raise ValueError("embedding_bag: weights must be float "
                             f"{tuple(idx.shape)}, got {weights.dtype} "
                             f"{tuple(weights.shape)}")
        devices.add(weights.device)
    if len(devices) > 1:
        raise ValueError("embedding_bag: inputs on different devices")


def _meta(table, idx, weights, out_dtype):
    """The shape-only path: the output, empty, and the kernel's work
    reported to ``roofline.cost``: ``B bag d`` f32 adds, the ids (and
    weights) read, one table row per id (no values: every id counts as
    a row), the output written."""
    from ...roofline import cost
    B, bag = idx.shape
    d = table.shape[1]
    out = torch.empty((B, d), dtype=out_dtype, device=table.device)
    nbytes = (idx.numel() * idx.element_size()
              + B * bag * d * table.element_size()
              + out.numel() * out.element_size())
    if weights is not None:
        nbytes += weights.numel() * 4
    cost.kernel("embedding_bag", flops=B * bag * d, dtype=torch.float32,
                nbytes=nbytes)
    return out


def embedding_bag(table, idx, weights=None, out_dtype=None):
    """EmbeddingBag(sum) with ``-1`` padding (see the kernel source);
    the output in ``out_dtype`` (the table's or float32; default the
    table's)."""
    out_dtype = table.dtype if out_dtype is None else out_dtype
    _check_inputs(table, idx, weights, out_dtype)
    device = table.device
    if device.type == "cpu":
        return embedding_bag_ref(table, idx, weights, out_dtype)
    if device.type == "meta":
        from ...roofline import cost
        if cost.active() is not None:
            return _meta(table, idx, weights, out_dtype)
    if device.type != "cuda":
        raise ValueError(f"embedding_bag: no kernel for device {device}")
    V, d = table.shape
    B, bag = idx.shape
    table, idx = table.contiguous(), idx.contiguous()
    if weights is not None:
        weights = weights.to(torch.float32).contiguous()
    out = torch.empty((B, d), dtype=out_dtype, device=device)
    if out.numel() == 0:
        return out
    vec = int(d * table.element_size() % 16 == 0
              and table.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    flags = (int(table.dtype == torch.bfloat16)
             | int(idx.dtype == torch.int64) << 1 | vec << 2
             | int(out_dtype != table.dtype) << 3)
    lib = _build.library("embedding_bag")
    fn = lib.embedding_bag_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(table.data_ptr(), idx.data_ptr(),
                None if weights is None else weights.data_ptr(),
                out.data_ptr(), V, d, B, bag, flags, stream)
    _build.check(rc, "embedding_bag")
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0

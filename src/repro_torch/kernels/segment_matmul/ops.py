"""Wrappers of the two grouped-GEMM kernels and the segment-padding
helper.

``segment_matmul(x, w, block_groups)`` computes ``y[i] = x[i] @
w[g(i)]`` with one group id per ``bm``-row block, as the JAX package's
``segment_matmul`` does: f32 accumulation, the output in ``x``'s dtype.
It takes the plain torch version (``ref.py``) for CPU tensors and
launches a CUDA kernel for CUDA tensors; on any other device, or on
inputs the kernels do not take, it raises.  On the card it dispatches on
dtype and widths (``kernel_for``): bf16 with K and N positive multiples
of 8 goes to ``csrc/segment_matmul_sm90.cu`` (wgmma fed by a TMA ring),
every other input to ``csrc/segment_matmul.cu`` (mma.sync for bf16, f32
FMAs for f32).  A failed build or launch raises; neither kernel stands
in for the other.

``segment_matmul.launches`` counts every kernel launch,
``segment_matmul.launches_sm90`` and ``segment_matmul.launches_simt``
each kernel's own.

Group ids out of ``[0, G)`` would read outside ``w``: the wrapper checks
them when ``block_groups`` lies on the host (it is then copied to the
card); ids already on the card are not read back (that would make the
host wait), and a block whose id is out of range writes NaN instead of
reading outside ``w``.

On meta tensors inside ``roofline.cost.counting()`` (the dry run) it
launches nothing: it returns an empty output of the kernel's shape and
dtype and reports the kernel's work (``_meta``); outside that region a
meta tensor raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build, tma_ready
from .ref import segment_matmul_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Every launch takes x, w, groups, y; M, K, N, nblocks, G; then its own
# tail; then the stream.
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5


def pad_segments(x: np.ndarray, group_sizes: np.ndarray, bm: int = 128):
    """Round each group's row segment up to a multiple of ``bm``.

    A copy of ``repro.kernels.segment_matmul.ops.pad_segments`` (numpy,
    on the host): returns (x_padded ``[Mp, K]``, block_groups ``[Mp/bm]``
    int32, row_index ``[Mp]`` int64 with -1 on pad rows) so outputs can
    be scattered back.
    """
    group_sizes = np.asarray(group_sizes)
    G = len(group_sizes)
    starts = np.concatenate([[0], np.cumsum(group_sizes)[:-1]])
    padded = np.maximum(-(-group_sizes // bm) * bm, 0)
    Mp = int(padded.sum())
    row_index = np.full(Mp, -1, dtype=np.int64)
    block_groups = np.zeros(Mp // bm, dtype=np.int32)
    pos = 0
    for g in range(G):
        n, s = int(group_sizes[g]), int(starts[g])
        row_index[pos:pos + n] = np.arange(s, s + n)
        block_groups[pos // bm:(pos + int(padded[g])) // bm] = g
        pos += int(padded[g])
    xp = np.zeros((Mp,) + x.shape[1:], dtype=x.dtype)
    keep = row_index >= 0
    xp[keep] = np.asarray(x)[row_index[keep]]
    return xp, block_groups, row_index


def _check_inputs(x, w, block_groups):
    if x.dim() != 2 or w.dim() != 3 or block_groups.dim() != 1:
        raise ValueError("segment_matmul: x must be [M, K], w [G, K, N] and "
                         f"block_groups [nblocks], got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(block_groups.shape)}")
    M, K = x.shape
    G, Kw, N = w.shape
    nb = block_groups.shape[0]
    if Kw != K:
        raise ValueError(f"segment_matmul: x has K = {K}, w has {Kw}")
    if nb == 0 or M % nb:
        raise ValueError(f"segment_matmul: M = {M} rows are not "
                         f"{nb} blocks of equal size")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError("segment_matmul: x and w must share one dtype of "
                         f"float32 / bfloat16, got {x.dtype}, {w.dtype}")
    if block_groups.dtype not in (torch.int32, torch.int64):
        raise ValueError("segment_matmul: block_groups must be int32 or "
                         f"int64, got {block_groups.dtype}")
    if x.device != w.device:
        raise ValueError("segment_matmul: x and w on different devices")
    if block_groups.device.type == "cpu" and nb and (
            int(block_groups.min()) < 0 or int(block_groups.max()) >= G):
        raise ValueError(f"segment_matmul: group ids outside [0, {G})")
    if block_groups.device.type != "cpu" and block_groups.device != x.device:
        raise ValueError("segment_matmul: block_groups on another card")


def kernel_for(dtype: torch.dtype, K: int, N: int) -> str:
    """The kernel a CUDA call launches: ``"segment_matmul_sm90"`` for bf16
    when K and N are positive multiples of 8 (the 16-byte strides TMA
    needs), else ``"segment_matmul"``."""
    if dtype == torch.bfloat16 and K > 0 and K % 8 == 0 and N % 8 == 0:
        return "segment_matmul_sm90"
    return "segment_matmul"


def _meta(x, w, block_groups):
    """The shape-only path: the output, empty, and the kernel's work
    reported to ``roofline.cost``: ``2 M K N`` flops, x, w and y moved
    once."""
    from ...roofline import cost
    M, K = x.shape
    N = w.shape[2]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    cost.kernel(kernel_for(x.dtype, K, N), flops=2 * M * K * N,
                dtype=x.dtype,
                nbytes=(x.numel() + w.numel() + y.numel()) * x.element_size())
    return y


def segment_matmul(x, w, block_groups):
    """Grouped GEMM on pre-padded rows (see the kernel sources)."""
    if isinstance(block_groups, np.ndarray):
        block_groups = torch.as_tensor(block_groups)
    _check_inputs(x, w, block_groups)
    device = x.device
    if device.type == "cpu":
        return segment_matmul_ref(x, w, block_groups)
    if device.type == "meta":
        from ...roofline import cost
        if cost.active() is not None:
            return _meta(x, w, block_groups)
    if device.type != "cuda":
        raise ValueError(f"segment_matmul: no kernel for device {device}")
    return _launch(kernel_for(x.dtype, x.shape[1], w.shape[2]), x, w,
                   block_groups)


def _segment_matmul_simt(x, w, block_groups):
    """The mma.sync / f32 kernel on any input it takes, bf16 with widths
    the sm90 kernel takes included: for timing it beside the sm90 kernel
    on the same work.  Never called on the path."""
    if isinstance(block_groups, np.ndarray):
        block_groups = torch.as_tensor(block_groups)
    _check_inputs(x, w, block_groups)
    if x.device.type != "cuda":
        raise ValueError(f"segment_matmul: no kernel for device {x.device}")
    return _launch("segment_matmul", x, w, block_groups)


def _launch(kernel, x, w, block_groups):
    device = x.device
    M, K = x.shape
    G, _, N = w.shape
    y = torch.empty((M, N), dtype=x.dtype, device=device)
    if y.numel() == 0:
        return y
    groups = block_groups.to(device=device, dtype=torch.int32).contiguous()
    if kernel == "segment_matmul_sm90":
        x, w = (t if tma_ready(t)
                else t.clone(memory_format=torch.contiguous_format)
                for t in (x, w))
        # the row stride of x, the group and k strides of w
        tail = (x.stride(0), w.stride(0), w.stride(1))
        counter = "launches_sm90"
    else:
        x, w = x.contiguous(), w.contiguous()
        vec_elems = 16 // x.element_size()
        vec = int(K % vec_elems == 0 and N % vec_elems == 0
                  and all(t.data_ptr() % 16 == 0 for t in (x, w, y)))
        tail = (_DTYPES[x.dtype] | vec << 1,)  # flags
        counter = "launches_simt"
    lib = _build.library(kernel)
    fn = getattr(lib, f"{kernel}_launch")
    fn.argtypes = _ARGS + [ctypes.c_int64] * len(tail) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), groups.data_ptr(), y.data_ptr(),
                M, K, N, groups.shape[0], G, *tail, stream)
    _build.check(rc, kernel)
    segment_matmul.launches += 1
    setattr(segment_matmul, counter, getattr(segment_matmul, counter) + 1)
    return y


segment_matmul.launches = 0
segment_matmul.launches_sm90 = 0
segment_matmul.launches_simt = 0

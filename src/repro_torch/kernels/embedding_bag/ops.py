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

The launch geometry (threads a bag, bags a thread, blocks) is chosen
here, by ``launch_geometry``, and handed to the kernel; the per-call
host work is kept small (the entry point typed once, the geometry kept,
the raw stream handle), since a small lookup's kernel takes ~30 us.

On meta tensors inside ``roofline.cost.counting()`` (the dry run) it
launches nothing: it returns an empty output of the kernel's shape and
dtype and reports the kernel's work (``_meta``); outside that region a
meta tensor raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from .ref import embedding_bag_ref

_LAUNCH_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 8
                + [ctypes.c_void_p])

#: threads of a block, row chunks a thread sends in one stage and bags a
#: thread takes at most (the kernel's ``kThreads``, ``kInFlight`` and its
#: largest ``BPT``)
THREADS = 128
IN_FLIGHT = 8
MAX_BPT = 4


class Geometry(NamedTuple):
    """A launch: ``tpr`` threads a bag, ``bpt`` bags a thread, ``grid``
    blocks of ``THREADS``."""
    tpr: int
    bpt: int
    grid: int


@functools.lru_cache(maxsize=256)      # a serving loop repeats its shapes
def launch_geometry(B: int, d: int, bag: int, elem_size: int,
                    vec: bool) -> Geometry:
    """The kernel's launch for ``B`` bags of ``bag`` slots over rows of
    ``d`` elements of ``elem_size`` bytes, read 16 bytes a copy when
    ``vec`` (else one element a load).

    The kernel's mapping: a thread group of ``tpr`` threads takes a bag,
    lane ``l`` of it the chunks ``l, l + tpr, ...`` of the row (a chunk is
    16 bytes, or one element without ``vec``), so a block takes ``THREADS
    // tpr`` consecutive bags a round and ``bpt`` consecutive rounds a
    batch, a thread one bag of each round and ``IN_FLIGHT // bpt`` slots
    of each bag at once; block ``x`` takes batches ``x, x + grid, ...``.
    ``tpr`` is the least power of two that covers a row's chunks, at most
    32; ``bpt`` fills ``IN_FLIGHT`` with whole bags of one or a few slots,
    at most ``MAX_BPT`` (1 without ``vec``); one block a batch (faster
    on an H100 than a grid sized to the card:
    ``scripts/embedding_bag_variants.py``).
    """
    per = 16 // elem_size if vec else 1
    chunks = -(-d // per)
    tpr = min(32, 1 << max(0, chunks - 1).bit_length())
    fit = IN_FLIGHT // max(bag, 1)
    bpt = min(MAX_BPT, 1 << (fit.bit_length() - 1)) if vec and fit else 1
    rounds = -(-B // (THREADS // tpr))
    return Geometry(tpr, bpt, max(1, min(-(-rounds // bpt), 2**31 - 1)))


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
    here = torch.cuda.current_device()
    if device.index not in (None, here):
        with torch.cuda.device(device):     # launch where the tensors are
            return embedding_bag(table, idx, weights, out_dtype)
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
    g = launch_geometry(B, d, bag, table.element_size(), vec)
    fn = _build.library("embedding_bag").embedding_bag_launch  # a lookup
    if fn.argtypes is None:                     # typed once per process
        fn.argtypes, fn.restype = _LAUNCH_ARGS, ctypes.c_int
    rc = fn(
        table.data_ptr(), idx.data_ptr(),
        None if weights is None else weights.data_ptr(), out.data_ptr(), V,
        d, B, bag, flags, g.tpr, g.bpt, g.grid,
        torch._C._cuda_getCurrentRawStream(here))   # current_stream(): 7 us
    _build.check(rc, "embedding_bag")
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0

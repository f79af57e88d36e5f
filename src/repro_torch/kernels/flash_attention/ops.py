"""Wrappers of the two flash-attention kernels.

Keeps the JAX package's public layout: q ``[B, Sq, Hq, D]``, k/v
``[B, Skv, Hkv, D]``, out ``[B, Sq, Hq, D]`` in q's dtype.
``flash_attention`` takes the plain torch version (``ref.py``) for CPU
tensors and launches a CUDA kernel for CUDA tensors; on any other
device, or on inputs the kernels do not take, it raises.  On the card it
dispatches on dtype and head dim (``kernel_for``): bf16 at head dims 64
and 128 goes to ``csrc/flash_attention_sm90.cu`` (wgmma fed by TMA; p
rounded to bf16 before P.V, as the LM's JAX reference rounds it), every
other input to ``csrc/flash_attention.cu`` (CUDA cores, f32 p).  Both
read 16-byte rows: a view whose rows are not 16-byte aligned is copied
first.  A failed build or launch raises; neither kernel stands in for
the other.

``flash_attention.launches`` counts every kernel launch,
``flash_attention.launches_sm90`` and ``flash_attention.launches_simt``
each kernel's own.

On meta tensors inside ``roofline.cost.counting()`` (the dry run) it
launches nothing: it returns an empty output of the kernel's shape and
dtype and reports the kernel's work (``_meta``).  Outside that region a
meta tensor raises, as any device without a kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, tma_ready
from .ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)
SM90_HEAD_DIMS = (64, 128)      # bf16 only
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 20
             + [ctypes.c_float] * 2 + [ctypes.c_int64, ctypes.c_void_p])


def _check_inputs(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: q must be [B, Sq, Hq, D] and k, "
                         "v one [B, Skv, Hkv, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    Bk, Skv, Hkv, Dk = k.shape
    if Bk != B or Dk != D:
        raise ValueError("flash_attention: q and k/v differ in batch or "
                         f"head dim: {tuple(q.shape)} vs {tuple(k.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: {Hq} query heads are not a "
                         f"multiple of {Hkv} kv heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k, v must share one dtype of "
                         f"float32 / bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: inputs on different devices")
    if max(Sq, Skv) >= 2 ** 31:
        raise ValueError("flash_attention: sequence longer than 2^31 - 1")
    if Sq and Skv == 0:
        raise ValueError("flash_attention: no keys to attend")
    if window > 0 and Sq > Skv + window - 1:
        raise ValueError(f"flash_attention: query rows past {Skv + window - 2}"
                         f" see no key in their window of {window}")


def kernel_for(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call launches: ``"flash_attention_sm90"`` for
    bf16 at head dims 64 and 128, else ``"flash_attention"``."""
    if dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS:
        return "flash_attention_sm90"
    return "flash_attention"


def attended_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask lets through: one head's work.  Query
    ``i`` sees keys ``[lo, hi)``, the rows of ``ref.visible``, summed in
    closed form (no ``[Sq, Skv]`` mask)."""
    qpos = torch.arange(Sq, dtype=torch.int64)
    hi = (qpos + 1).clamp(max=Skv) if causal else torch.full_like(qpos, Skv)
    lo = ((qpos - window + 1).clamp(min=0) if window > 0
          else torch.zeros_like(qpos))
    return int((hi - lo).clamp(min=0).sum())


def _meta(q, k, v, causal, window, attn_softcap):
    """The shape-only path: the kernel's output, empty, and its work
    reported to ``roofline.cost``: ``4 D`` flops per attended pair and
    head (QK^T and PV), one ex2 a pair for the softmax plus an ex2 and a
    reciprocal for the softcap's tanh, q, k, v and the output moved
    once."""
    from ...roofline import cost
    B, Sq, Hq, D = q.shape
    pairs = attended_pairs(Sq, k.shape[1], bool(causal), int(window)) * B * Hq
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    cost.kernel(kernel_for(q.dtype, D), flops=4 * D * pairs, dtype=q.dtype,
                nbytes=sum(x.numel() * x.element_size()
                           for x in (q, k, v, out)),
                sfu=pairs * (3 if attn_softcap else 1))
    return out


def flash_attention_grads_meta(q, k, v, *, causal, window, attn_softcap):
    """The shape-only path of the flash backward (``models.attention.
    FlashAttentionFn``), inside ``roofline.cost.counting()`` only: dq,
    dk, dv empty, and the work reported by formula, as the kernels'
    meta paths report theirs: the backward recomputes the forward
    (QK^T, PV: ``4 D`` flops an attended pair and head, its ex2 and the
    softcap's) and differentiates it (dV, dP, dQ, dK: ``8 D``), reading
    q, k, v and the output's gradient once and writing dq, dk, dv once.
    Its plain blockwise ops on the card do more (every pair of a block,
    masked or not); the count is the work, not those ops."""
    if not _counting(q):
        raise ValueError("flash_attention: no kernel for device "
                         f"{q.device}")
    from ...roofline import cost
    B, Sq, Hq, D = q.shape
    pairs = attended_pairs(Sq, k.shape[1], bool(causal), int(window)) * B * Hq
    grads = tuple(torch.empty_like(x) for x in (q, k, v))
    cost.kernel("flash_attention backward", flops=12 * D * pairs,
                dtype=q.dtype, nbytes=sum(n * x.numel() * x.element_size()
                                          for n, x in ((3, q), (2, k), (2, v))),
                sfu=pairs * (3 if attn_softcap else 1))
    return grads


def _counting(x) -> bool:
    """A meta tensor inside the roofline's counter."""
    if x.device.type != "meta":
        return False
    from ...roofline import cost
    return cost.active() is not None


def flash_attention(q, k, v, *, causal=True, window=0, attn_softcap=0.0):
    """GQA attention with online softmax (see the kernel sources)."""
    _check_inputs(q, k, v, window)
    device = q.device
    if device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   attn_softcap=attn_softcap)
    if _counting(q):
        return _meta(q, k, v, causal, window, attn_softcap)
    if device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {device}")
    return _launch(kernel_for(q.dtype, q.shape[-1]), q, k, v, causal,
                   window, attn_softcap)


def _flash_attention_simt(q, k, v, *, causal=True, window=0,
                          attn_softcap=0.0):
    """The CUDA-core kernel on any input it takes, bf16 at head dims 64
    and 128 included: for timing it beside the sm90 kernel on the same
    work.  Never called on the path."""
    _check_inputs(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device "
                         f"{q.device}")
    return _launch("flash_attention", q, k, v, causal, window, attn_softcap)


def _launch(kernel, q, k, v, causal, window, attn_softcap):
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    # both kernels read rows of 16 bytes: a view whose rows are not
    # 16-byte aligned is copied first
    q, k, v = (x if tma_ready(x)
               else x.clone(memory_format=torch.contiguous_format)
               for x in (q, k, v))
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _build.library(kernel)
    fn = getattr(lib, f"{kernel}_launch")
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    strides = [s for x in (q, k, v, out) for s in x.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, Sq, Skv, Hq, Hkv, D, *strides, int(causal), int(window),
                D ** -0.5, float(attn_softcap), _DTYPES[q.dtype], stream)
    _build.check(rc, kernel)
    flash_attention.launches += 1
    if kernel == "flash_attention_sm90":
        flash_attention.launches_sm90 += 1
    else:
        flash_attention.launches_simt += 1
    return out


flash_attention.launches = 0
flash_attention.launches_sm90 = 0
flash_attention.launches_simt = 0

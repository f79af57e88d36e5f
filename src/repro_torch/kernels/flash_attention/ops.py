"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

Keeps the JAX package's public layout: q ``[B, Sq, Hq, D]``, k/v
``[B, Skv, Hkv, D]``, out ``[B, Sq, Hq, D]`` in q's dtype.
``flash_attention`` takes the plain torch version (``ref.py``) for CPU
tensors and launches the CUDA kernel for CUDA tensors; on any other
device, or on inputs the kernel does not take, it raises.
``flash_attention.launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)
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


def flash_attention(q, k, v, *, causal=True, window=0, attn_softcap=0.0):
    """GQA attention with online softmax (see the kernel source)."""
    _check_inputs(q, k, v, window)
    device = q.device
    if device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   attn_softcap=attn_softcap)
    if device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {device}")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=device)
    if out.numel() == 0:
        return out
    lib = _build.library("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    strides = [s for x in (q, k, v, out) for s in x.stride()[:3]]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, Sq, Skv, Hq, Hkv, D, *strides, int(causal), int(window),
                D ** -0.5, float(attn_softcap), _DTYPES[q.dtype], stream)
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

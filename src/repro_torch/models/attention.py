"""Attention: GQA with causal / sliding-window masks, softcap, KV cache.

The port of ``repro.models.attention``.  Paths, selected by ``impl``:

* ``"flash"`` (default) and ``"pallas"`` — the hand-written CUDA
  flash-attention kernels (``kernels/flash_attention``: wgmma for bf16
  at head dims 64 and 128, CUDA cores otherwise) on CUDA tensors, the
  plain torch version on CPU tensors.  The reference's ``"flash"``
  computes the same online-softmax function in jnp, and its ``"pallas"``
  is the Pallas kernel the CUDA kernel replaces, so both land there;
* ``"naive"`` — the ``[S, S]`` reference, with explicit positions and
  ``kv_len`` (small shapes and tests).

``attention_decode`` (one query against the cache) stays plain torch
ops, as the reference computes it outside any Pallas kernel.

Shapes: q ``[B, Sq, Hq, D]``, k/v ``[B, Skv, Hkv, D]``; Hq % Hkv == 0.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.flash_attention.ops import HEAD_DIMS, flash_attention
from ..kernels.flash_attention.ref import NEG_INF, visible


def attention_naive(q, k, v, *, causal=True, window=0, attn_softcap=0.0,
                    q_positions=None, kv_positions=None, kv_len=None):
    """Reference attention; materialises scores (small shapes only)."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    qpos = (torch.arange(Sq, device=q.device) if q_positions is None
            else q_positions)
    kpos = (torch.arange(Skv, device=q.device) if kv_positions is None
            else kv_positions)
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * D ** -0.5
    if attn_softcap:
        s = attn_softcap * torch.tanh(s / attn_softcap)
    m = visible(qpos, kpos, causal, window)
    if kv_len is not None:  # mask unwritten cache slots
        m &= (kpos < kv_len)[None, :]
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


def attention_flash(q, k, v, *, causal=True, window=0, attn_softcap=0.0):
    """Online-softmax attention with implicit positions ``0..S-1``: the
    CUDA kernel on the card (see ``kernels/flash_attention/ops.py``).

    A head dim the kernel has no build for (12 in a smoke config) is
    zero-padded to the next one it has, Dp; q is first multiplied by
    ``(Dp / D) ** 0.5``, so the kernel's ``Dp ** -0.5`` scales the scores
    by ``D ** -0.5`` (the zero columns add exact zeros to every product).
    """
    D = q.shape[-1]
    Dp = next((h for h in HEAD_DIMS if h >= D), D)
    if Dp == D:
        return flash_attention(q, k, v, causal=causal, window=window,
                               attn_softcap=attn_softcap)
    q = q * (Dp / D) ** 0.5
    q, k, v = (F.pad(x, (0, Dp - D)) for x in (q, k, v))
    return flash_attention(q, k, v, causal=causal, window=window,
                           attn_softcap=attn_softcap)[..., :D]


def attention_decode(q, k_cache, v_cache, *, kv_len, window=0,
                     attn_softcap=0.0):
    """Single-step decode: q ``[B, 1, Hq, D]`` against a ``[B, S, Hkv, D]``
    cache.

    ``kv_len`` (int or ``[B]`` tensor) = valid cache slots; positions are
    implicit ``0..kv_len-1`` and the query sits at ``kv_len - 1`` (the
    cache already holds its key).  The reference keeps the cache in its
    storage dtype and asks its products for f32 results; a torch matmul
    of two bf16 tensors returns bf16, so here the cache is upcast to f32
    (a copy of every visible slot in every layer, the main cost of a
    decode step) and the products run in f32.  As the reference, the
    probabilities are rounded to the cache dtype before ``p @ v``.
    """
    B, _, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    if isinstance(kv_len, int):      # no host-to-device copy
        qpos = kv_len - 1
    else:
        kv_len = torch.as_tensor(kv_len, device=q.device)
        qpos = (kv_len - 1).reshape(-1)[:, None]             # [B or 1, 1]
    kpos = torch.arange(S, device=q.device)[None, :]         # [1, S]
    qg = q.reshape(B, Hkv, G, D).to(k_cache.dtype)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(),
                     k_cache.float()) * D ** -0.5
    if attn_softcap:
        s = attn_softcap * torch.tanh(s / attn_softcap)
    ok = kpos <= qpos
    if window > 0:
        ok &= qpos - kpos < window
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, Hq, D).to(q.dtype)


def attention(q, k, v, *, impl="flash", **kw):
    if impl == "naive":
        return attention_naive(q, k, v, **kw)
    if impl in ("flash", "pallas"):
        return attention_flash(q, k, v, **kw)
    raise ValueError(f"unknown attention impl {impl!r}")

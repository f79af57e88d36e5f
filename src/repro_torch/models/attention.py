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

``attention_flash`` is differentiable: ``FlashAttentionFn`` runs the
kernel forward, and its backward differentiates ``attention_blockwise``,
the torch-op port of the reference's jnp ``attention_flash`` (the
function the reference's training differentiates), one query block at a
time, as the reference's ``jax.checkpoint`` of each query block does.

``attention_decode`` (one query against the cache) stays plain torch
ops, as the reference computes it outside any Pallas kernel;
``attention_decode_sharded`` is its flash-decoding form on a mesh (the
cache's sequence sharded over ranks).

Shapes: q ``[B, Sq, Hq, D]``, k/v ``[B, Skv, Hkv, D]``; Hq % Hkv == 0.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist import collectives as coll
from ..kernels.flash_attention.ops import (HEAD_DIMS, flash_attention,
                                           flash_attention_grads_meta)
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


# the reference's attention_flash block sizes
Q_BLOCK, KV_BLOCK = 512, 1024


def attention_blockwise(q, k, v, *, causal=True, window=0,
                        attn_softcap=0.0, q_block=Q_BLOCK,
                        kv_block=KV_BLOCK, q_offset=0):
    """The reference's jnp ``attention_flash`` in torch ops: online
    softmax over ``kv_block`` keys for each ``q_block`` of queries, the
    scores, running max and sum in f32 (the products of the storage
    dtype summed in f32, as ``preferred_element_type=f32`` does), p cast
    to v's dtype before ``p @ v``, output in q's dtype.

    Positions are implicit: the queries sit at ``q_offset + 0..Sq-1``
    and the keys at ``0..Skv-1``.  A kv block that no query of the q
    block can see is skipped: in the reference it adds ``exp(NEG_INF -
    m) = 0`` to every sum, or it is wiped by ``corr = 0`` at the first
    visible block, so skipping it changes no value.  The running max is
    held out of the graph: the output does not depend on it.
    """
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    q_block, kv_block = min(q_block, Sq), min(kv_block, Skv)
    kh = k.permute(0, 2, 3, 1).float()                     # [B, Hkv, D, S]
    vh = v.transpose(1, 2)                                 # [B, Hkv, S, D]
    outs = []
    for q0 in range(0, Sq, q_block):
        n = min(q_block, Sq - q0)
        lo_q, hi_q = q_offset + q0, q_offset + q0 + n - 1
        qpos = torch.arange(lo_q, hi_q + 1, device=q.device)
        qh = (q[:, q0:q0 + n].reshape(B, n, Hkv, G, D).permute(0, 2, 1, 3, 4)
              .reshape(B, Hkv, n * G, D).float())
        acc = torch.zeros((B, Hkv, n * G, D), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, Hkv, n * G), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, n * G), device=q.device)
        k_lo = max(0, lo_q - window + 1) if window > 0 else 0
        k_hi = min(Skv, hi_q + 1) if causal else Skv
        for k0 in range(0, Skv, kv_block):
            if k0 + kv_block <= k_lo or k0 >= k_hi:
                continue                     # no query here sees a key
            kpos = torch.arange(k0, min(k0 + kv_block, Skv), device=q.device)
            s = (qh @ kh[..., k0:k0 + kv_block]) * scale    # [B,Hkv,nG,kb]
            if attn_softcap:
                s = attn_softcap * torch.tanh(s / attn_softcap)
            ok = visible(qpos, kpos, causal, window)[:, None, :]  # [n,1,kb]
            s = torch.where(ok, s.view(B, Hkv, n, G, -1), NEG_INF).view(
                B, Hkv, n * G, -1)
            m_new = torch.maximum(m, s.detach().amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + (
                p.to(v.dtype).float() @ vh[:, :, k0:k0 + kv_block].float())
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.view(B, Hkv, n, G, D).permute(0, 2, 1, 3, 4)
                    .reshape(B, n, Hq, D))
    return torch.cat(outs, dim=1).to(q.dtype)


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` (the kernel on the card, its plain version on
    the CPU) with a gradient.

    The backward runs ``attention_blockwise`` again one ``Q_BLOCK`` of
    queries at a time and differentiates it, summing dK and dV over the
    query blocks in f32: only one query block's scores are held at once
    (about 50 MB per kv block at S 4096 and 24 heads), as the
    reference's checkpointed ``per_q_block`` recomputes them.  On meta
    tensors (the roofline's count) the backward runs nothing and reports
    its work by formula (``flash_attention_grads_meta``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, attn_softcap):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window,
                      attn_softcap=attn_softcap)
        return flash_attention(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        if q.is_meta:        # the roofline's count: the work by its formula
            return flash_attention_grads_meta(q, k, v, **ctx.kw) + (
                None, None, None)
        dq = torch.empty_like(q)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        with torch.enable_grad():
            kk, vv = (x.detach().requires_grad_() for x in (k, v))
            for q0 in range(0, q.shape[1], Q_BLOCK):
                rows = slice(q0, q0 + Q_BLOCK)
                qi = q[:, rows].detach().requires_grad_()
                o = attention_blockwise(qi, kk, vv, q_offset=q0, **ctx.kw)
                gq, gk, gv = torch.autograd.grad(o, (qi, kk, vv),
                                                 grad_out[:, rows])
                dq[:, rows] = gq
                dk += gk
                dv += gv
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None


def attention_flash(q, k, v, *, causal=True, window=0, attn_softcap=0.0):
    """Online-softmax attention with implicit positions ``0..S-1``: the
    CUDA kernel on the card (see ``kernels/flash_attention/ops.py``),
    differentiable through ``FlashAttentionFn``.

    A head dim the kernel has no build for (12 in a smoke config) is
    zero-padded to the next one it has, Dp; q is first multiplied by
    ``(Dp / D) ** 0.5``, so the kernel's ``Dp ** -0.5`` scales the scores
    by ``D ** -0.5`` (the zero columns add exact zeros to every product).
    """
    D = q.shape[-1]
    Dp = next((h for h in HEAD_DIMS if h >= D), D)
    if Dp == D:
        return FlashAttentionFn.apply(q, k, v, causal, window, attn_softcap)
    q = q * (Dp / D) ** 0.5
    q, k, v = (F.pad(x, (0, Dp - D)) for x in (q, k, v))
    return FlashAttentionFn.apply(q, k, v, causal, window,
                                  attn_softcap)[..., :D]


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


def attention_decode_sharded(q, k_cache, v_cache, *, kv_len, offset: int,
                             group, window=0, attn_softcap=0.0):
    """Flash-decoding: q ``[B, 1, Hq, D]`` (every head) against this
    rank's slice ``[B, S_loc, Hkv, D]`` of the cache, which holds
    positions ``offset .. offset + S_loc - 1``; the query sits at
    ``kv_len - 1``.  Each rank takes its slots' max, its sum of
    ``exp(s - M)`` and its ``exp(s - M) @ v`` under the group's max
    ``M``; the sums and outputs are added over ``group`` and divided
    (the reference's psum of the softmax statistics and the output).
    As ``attention_decode``: f32 products, the probabilities rounded to
    the cache dtype before ``@ v`` (here unnormalised, so in bf16 the
    result differs from one process's by that rounding)."""
    B, _, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    kpos = offset + torch.arange(S, device=q.device)
    qg = q.reshape(B, Hkv, G, D).to(k_cache.dtype)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(),
                     k_cache.float()) * D ** -0.5
    if attn_softcap:
        s = attn_softcap * torch.tanh(s / attn_softcap)
    ok = kpos <= kv_len - 1
    if window > 0:
        ok &= kv_len - 1 - kpos < window
    s = torch.where(ok[None, None, None, :], s, NEG_INF)
    m = coll.pmax(s.amax(dim=-1), group)                     # [B, Hkv, G]
    p = torch.exp(s - m[..., None])
    l = coll.all_reduce(p.sum(dim=-1), group)
    o = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    o = coll.all_reduce(o, group) / l[..., None]
    return o.reshape(B, 1, Hq, D).to(q.dtype)


def attention(q, k, v, *, impl="flash", **kw):
    if impl == "naive":
        return attention_naive(q, k, v, **kw)
    if impl in ("flash", "pallas"):
        return attention_flash(q, k, v, **kw)
    raise ValueError(f"unknown attention impl {impl!r}")

"""Plain torch version of the flash-attention kernel (materialised scores).

The port of ``repro.kernels.flash_attention.ref.attention_ref``: f32
scores, the same ``NEG_INF`` and the same mask rules (implicit positions
``0..S-1``; ``qpos >= kpos`` when causal, ``qpos - kpos < window`` when
``window > 0``).  Used on CPU tensors by ``ops.flash_attention`` and held
against the CUDA kernel on the card by ``chip_smoke.py``.

The scores are materialised one kv head (and its query group) at a
time, so the card can run it at S = 8192 without holding every head's
``[S, S]`` scores at once.

``round_p=True`` follows the trajectory of the sm90 kernel and of the
LM's JAX reference (``repro.models.attention._flash_inner``) instead: it
walks the keys in ``kv_tile`` tiles with a running max and rounds p to
the input dtype before ``P.V``, with ``l`` summed from the unrounded p.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def visible(qpos, kpos, causal: bool, window: int) -> torch.Tensor:
    """``[Sq, Skv]`` bool: True where the query at ``qpos[i]`` attends the
    key at ``kpos[j]``; ``window <= 0`` is unbounded."""
    ok = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                    device=qpos.device)
    if causal:
        ok &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        ok &= qpos[:, None] - kpos[None, :] < window
    return ok


def flash_attention_ref(q, k, v, *, causal=True, window=0, attn_softcap=0.0,
                        round_p=False, kv_tile=128):
    """q ``[B, Sq, Hq, D]``; k/v ``[B, Skv, Hkv, D]`` -> ``[B, Sq, Hq, D]``
    in ``q.dtype``."""
    if round_p:
        return _online_rounded(q, k, v, causal, window, attn_softcap,
                               kv_tile)
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    ok = visible(torch.arange(Sq, device=q.device),
                 torch.arange(Skv, device=q.device), causal, window)
    qg = q.reshape(B, Sq, Hkv, G, D)
    outs = []
    for h in range(Hkv):
        s = torch.einsum("bqgd,bkd->bgqk", qg[:, :, h].float(),
                         k[:, :, h].float())
        s = s * (D ** -0.5)
        if attn_softcap:
            s = attn_softcap * torch.tanh(s / attn_softcap)
        s = torch.where(ok, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        del s
        outs.append(torch.einsum("bgqk,bkd->bqgd", p, v[:, :, h].float()))
        del p
    return torch.stack(outs, dim=2).reshape(B, Sq, Hq, D).to(q.dtype)


def _online_rounded(q, k, v, causal, window, attn_softcap, kv_tile):
    """Online softmax over ``kv_tile``-key tiles, p rounded to ``q.dtype``
    before it multiplies v (f32 scores, running max, sum and output)."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    qpos = torch.arange(Sq, device=q.device)
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    m = torch.full((B, Sq, Hkv, G), NEG_INF, device=q.device)
    l = torch.zeros((B, Sq, Hkv, G), device=q.device)
    acc = torch.zeros((B, Sq, Hkv, G, D), device=q.device)
    for k0 in range(0, Skv, kv_tile):
        kb = k[:, k0:k0 + kv_tile].float()
        vb = v[:, k0:k0 + kv_tile].float()
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, kb) * (D ** -0.5)
        if attn_softcap:
            s = attn_softcap * torch.tanh(s / attn_softcap)
        ok = visible(qpos, torch.arange(k0, k0 + kb.shape[1],
                                        device=q.device), causal, window)
        s = torch.where(ok[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        del s
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqhgk,bkhd->bqhgd", p.to(q.dtype).float(), vb)
        m = m_new
        del p
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Sq, Hq, D).to(q.dtype)

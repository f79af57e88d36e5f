"""Plain torch version of the flash-attention kernel (materialised scores).

The port of ``repro.kernels.flash_attention.ref.attention_ref``: f32
scores, the same ``NEG_INF`` and the same mask rules (implicit positions
``0..S-1``; ``qpos >= kpos`` when causal, ``qpos - kpos < window`` when
``window > 0``).  Used on CPU tensors by ``ops.flash_attention`` and held
against the CUDA kernel on the card by ``chip_smoke.py``.

The scores are materialised one kv head (and its query group) at a
time, so the card can run it at S = 8192 without holding every head's
``[S, S]`` scores at once.
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


def flash_attention_ref(q, k, v, *, causal=True, window=0, attn_softcap=0.0):
    """q ``[B, Sq, Hq, D]``; k/v ``[B, Skv, Hkv, D]`` -> ``[B, Sq, Hq, D]``
    in ``q.dtype``."""
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

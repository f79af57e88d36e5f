"""Shared NN building blocks: norms, RoPE, MLPs, inits and the loss.

The port of ``repro.models.layers`` (the JAX package, which stays the
reference).  Same conventions: compute dtype bf16 with f32 norms, rotary
maths and losses, weights in ``[in, out]`` orientation so ``x @ w``
matches, every init deterministic from an explicit ``torch.Generator``.
``torch.Generator`` and ``jax.random`` give different numbers from one
seed, so the tests hand both packages the same numpy arrays instead.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def cast_for_compute(params, dtype=torch.bfloat16):
    """Cast the float tensors of a parameter tree (nested dicts and lists
    of tensors) to the compute dtype.

    A tensor already in ``dtype`` comes back as itself, so a model held
    in bf16 computes in bf16 without a copy.
    """
    if isinstance(params, dict):
        return {k: cast_for_compute(v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [cast_for_compute(v, dtype) for v in params]
    return params.to(dtype) if torch.is_floating_point(params) else params


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = True) -> torch.Tensor:
    """RMSNorm in f32, output in ``x.dtype``; zero-centred weight
    (``w + 1``, Gemma's storage) unless ``zero_centered=False``."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    w = scale.float()
    if zero_centered:
        w = w + 1.0
    return (y * w).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with the statistics in f32, output in ``x.dtype``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float = 10_000.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies ``[head_dim // 2]`` (f32)."""
    exponents = (torch.arange(0, head_dim, 2, dtype=torch.float32,
                              device=device) / head_dim)
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """Split-half rotary embedding (Llama / NeoX), computed in f32.

    x: ``[..., S, H, D]``; positions: broadcastable to ``[..., S]``.
    """
    d = x.shape[-1]
    inv = rope_frequencies(d, theta, device=x.device)           # [D/2]
    ang = positions[..., None].to(torch.float32) * inv          # [.., S, D/2]
    ang = ang[..., None, :]                                     # [.., S, 1, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 soft-capping: ``cap * tanh(x / cap)``."""
    return cap * torch.tanh(x / cap)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation (``jax.nn.gelu``'s default)."""
    return F.gelu(x, approximate="tanh")


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: ``down(silu(x @ gate) * (x @ up))``."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def geglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
          w_down: torch.Tensor) -> torch.Tensor:
    """GeGLU MLP (Gemma): ``down(gelu(x @ gate) * (x @ up))``."""
    return (gelu(x @ w_gate) * (x @ w_up)) @ w_down


def dense_init(shape, generator: torch.Generator, in_axis: int = 0,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated-normal fan-in init: ``N(0, 1)`` cut at +-3, times
    ``fan_in ** -0.5``; drawn in f32 on ``device``, then cast."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    w *= shape[in_axis] ** -0.5
    return w.to(dtype)


def embed_init(shape, generator: torch.Generator, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """``N(0, 0.02^2)`` embedding init; drawn in f32, then cast."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    w *= 0.02
    return w.to(dtype)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None,
                 z_loss: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy in f32, optional z-loss ``z_loss * lse^2``.

    logits ``[..., V]`` (any float dtype); labels int ``[...]``; mask
    broadcastable to labels (1 = count the position), averaged over
    ``max(sum(mask), 1)``.
    """
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.take_along_dim(lf, labels.long()[..., None], dim=-1)[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse ** 2
    if mask is None:
        return loss.mean()
    mask = mask.float()
    return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)

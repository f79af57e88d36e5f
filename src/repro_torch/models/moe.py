"""Mixture-of-Experts MLP with gather-based dispatch.

The port of ``repro.models.moe`` (the JAX package, which stays the
reference).  The same pipeline, with static shapes and GShard-style
capacity drops:

1. router logits (f32) -> top-k expert ids + renormalised gates ``[T, k]``
   and the Switch load-balancing aux;
2. a stable sort of the ``T * k`` (token, expert) assignments by expert;
   position in expert = rank - segment start (``searchsorted``);
3. token ids scattered into the ``[E_pad, C]`` slot table (positions past
   ``C`` go to a pad slot and are dropped);
4. gather ``xs = x[slot_token]`` ``[E_pad * C, d]``;
5. the expert SwiGLU: the gate, up and down products go through the
   grouped-GEMM kernel (``kernels/segment_matmul``) on the ``[E_pad * C,
   .]`` rows with one ``C``-row block per expert (``block_groups =
   arange(E_pad)``, made on the device) -- the reference's batched einsums
   ``ecd,edf->ecf``, with the same f32 accumulation and an output in the
   input dtype;
6. the gate multiply and the combine (a scatter-add over token ids) in
   f32, then the shared-expert SwiGLU.

Every step but 5 is torch ops.  The expert products are differentiable
through ``SegmentMatmulFn``: dX is the grouped-GEMM kernel again on the
transposed weights, dW a per-block ``x^T dy`` (the reference's einsum
transpose, which XLA computes outside any Pallas kernel).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.segment_matmul.ops import segment_matmul
from .layers import swiglu


def capacity(cfg, T: int) -> int:
    """Per-expert slot count C, rounded up to a multiple of 8."""
    c = int(T * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(8, -(-c // 8) * 8)


class SegmentMatmulFn(torch.autograd.Function):
    """``segment_matmul(x, w, block_groups)`` with its gradient.

    dX is ``segment_matmul(dy, w^T, block_groups)``: the grouped-GEMM
    kernel again on the card (for the bf16 MoE widths the sm90 kernel),
    f32 accumulation, out in dy's dtype.  dW is ``x_b^T dy_b`` for every
    ``bm``-row block b (``torch.bmm``, out in x's dtype, as the
    reference's bf16 einsum transpose), summed into each block's group
    in f32 and cast to w's dtype.  The group ids get no gradient."""

    @staticmethod
    def forward(ctx, x, w, block_groups):
        ctx.save_for_backward(x, w, block_groups)
        return segment_matmul(x, w, block_groups)

    @staticmethod
    def backward(ctx, dy):
        x, w, groups = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = segment_matmul(dy, w.transpose(1, 2).contiguous(), groups)
        if ctx.needs_input_grad[1]:
            nb, (M, K), N = groups.shape[0], x.shape, dy.shape[1]
            blocks = torch.bmm(x.reshape(nb, M // nb, K).transpose(1, 2),
                               dy.reshape(nb, M // nb, N))    # [nb, K, N]
            dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
            dw = dw.index_add_(0, groups.long(),
                               blocks.float()).to(w.dtype)
        return dx, dw, None


def router_probs(h2: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    """h2 ``[T, d]`` -> the router's softmax ``[T, n_experts]`` (f32)."""
    return torch.softmax(h2.float() @ router_w.float(), dim=-1)


def gates_and_aux(cfg, probs: torch.Tensor, experts: torch.Tensor):
    """The renormalised gates ``[T, k]`` of the chosen ``experts`` and the
    Switch load-balancing aux ``E * sum_e f_e * p_e`` (f32)."""
    gates = torch.take_along_dim(probs, experts, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    E = cfg.n_experts
    f = torch.zeros(E, dtype=torch.float32, device=probs.device).index_add_(
        0, experts.reshape(-1),
        torch.full((experts.numel(),), 1.0 / experts.numel(),
                   device=probs.device))
    aux = E * (f * probs.mean(dim=0)).sum()
    return gates, aux


def route(cfg, h2: torch.Tensor, router_w: torch.Tensor):
    """h2 ``[T, d]`` -> (gates ``[T, k]`` f32, experts ``[T, k]`` int64,
    aux scalar f32)."""
    probs = router_probs(h2, router_w)                          # [T, E]
    experts = torch.topk(probs, cfg.top_k, dim=-1).indices      # [T, k]
    gates, aux = gates_and_aux(cfg, probs, experts)
    return gates, experts, aux


def dispatch_tables(cfg, experts: torch.Tensor, C: int):
    """experts ``[T, k]`` -> slot_token ``[E_pad, C]`` (int64, -1 = empty)
    and slot_gatepos ``[E_pad, C]`` (flat index into the ``[T, k]`` gates,
    0 where empty).  Pad experts (>= n_experts) are never routed to and
    stay empty."""
    T, k = experts.shape
    E = cfg.e_pad
    dev = experts.device
    flat_e = experts.reshape(-1)                                # [T*k]
    order = torch.argsort(flat_e, stable=True)                  # token-stable
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    pos_in_e = torch.arange(T * k, device=dev) - seg_start[sorted_e]
    slot = torch.where(pos_in_e < C, sorted_e * C + pos_in_e, E * C)
    slot_token = torch.full((E * C + 1,), -1, dtype=torch.int64, device=dev)
    slot_token[slot] = order // k
    slot_gatepos = torch.zeros(E * C + 1, dtype=torch.int64, device=dev)
    slot_gatepos[slot] = order
    return slot_token[:-1].reshape(E, C), slot_gatepos[:-1].reshape(E, C)


def moe_mlp(cfg, h: torch.Tensor, p: dict):
    """h ``[B, S, d]`` -> (out ``[B, S, d]``, aux loss scalar)."""
    B, S, d = h.shape
    T = B * S
    E = cfg.e_pad
    h2 = h.reshape(T, d)
    gates, experts, aux = route(cfg, h2, p["router"])
    C = capacity(cfg, T)
    slot_token, slot_gatepos = dispatch_tables(cfg, experts, C)

    valid = slot_token >= 0                                     # [E, C]
    # index_select: its gradient is one index_add_ (the indexing
    # gradient, a sort, took 17 ms a layer at granite-moe's width)
    xs = h2.index_select(0, slot_token.clamp(min=0).reshape(-1))  # [E*C, d]
    xs = torch.where(valid.reshape(-1, 1), xs, 0.0)
    # the expert SwiGLU, one C-row block per expert: [E*C, d] @ [E, d, ffe]
    groups = torch.arange(E, dtype=torch.int32, device=h.device)
    g = F.silu(SegmentMatmulFn.apply(xs, p["moe_gate"], groups))
    u = SegmentMatmulFn.apply(xs, p["moe_up"], groups)
    ys = SegmentMatmulFn.apply(g * u, p["moe_down"], groups)    # [E*C, d]
    gate_per_slot = gates.reshape(-1)[slot_gatepos]             # [E, C] f32
    gate_per_slot = torch.where(valid, gate_per_slot, 0.0)
    # Gate-multiply and combine in f32, as the reference does.
    ys = ys.float() * gate_per_slot.reshape(-1, 1)
    dest = torch.where(valid, slot_token, T).reshape(-1)
    out = torch.zeros((T + 1, d), dtype=torch.float32, device=h.device)
    out = out.index_add_(0, dest, ys)[:T].to(h.dtype)
    if cfg.n_shared_experts > 0:
        out = out + swiglu(h2, p["shared_gate"], p["shared_up"],
                           p["shared_down"])
    return out.reshape(B, S, d), aux


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

Every step but 5 is torch ops.  On a model mesh (``moe_mlp``'s
``tp``) the experts are sharded over ``"model"`` (EP), with the
capacity, the slot order and the aux global over the data axes.  The
expert products are differentiable through ``SegmentMatmulFn``: dX is
the grouped-GEMM kernel again on the transposed weights, dW a per-block
``x^T dy`` (the reference's einsum transpose, which XLA computes outside
any Pallas kernel).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist.collectives import all_gather_dim, copy_to
from ..kernels.segment_matmul.ops import segment_matmul
from .layers import LOCAL, TensorParallel


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


def dispatch_tables(cfg, experts: torch.Tensor, C: int, prefix=None,
                    lo: int = 0, hi: int | None = None,
                    width: int | None = None):
    """experts ``[T, k]`` -> slot_token ``[hi - lo, W]`` (int64, -1 =
    empty) and slot_gatepos ``[hi - lo, W]`` (flat index into the ``[T,
    k]`` gates, 0 where empty) for experts ``lo .. hi - 1`` (default all
    ``E_pad``), ``W = width`` (default ``C``).  Pad experts (>=
    n_experts) are never routed to and stay empty.

    Under data parallelism ``prefix[e]`` (``[E_pad]``) is the number of
    tokens routed to ``e`` by the data ranks before this one: a token's
    global slot is its position in the global token order, and it is
    dropped when that reaches ``C``, as the reference's global table
    drops it.  Its row in this rank's table is its position among the
    rank's own tokens: ``width`` must exceed every kept one.
    """
    T, k = experts.shape
    hi = cfg.e_pad if hi is None else hi
    E, W = hi - lo, C if width is None else width
    dev = experts.device
    flat_e = experts.reshape(-1)                                # [T*k]
    order = torch.argsort(flat_e, stable=True)                  # token-stable
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e,
                                   torch.arange(cfg.e_pad, device=dev))
    pos_in_e = torch.arange(T * k, device=dev) - seg_start[sorted_e]
    glob = pos_in_e if prefix is None else pos_in_e + prefix[sorted_e]
    keep = (glob < C) & (sorted_e >= lo) & (sorted_e < hi)
    slot = torch.where(keep, (sorted_e - lo) * W + pos_in_e, E * W)
    slot_token = torch.full((E * W + 1,), -1, dtype=torch.int64, device=dev)
    slot_token[slot] = order // k
    slot_gatepos = torch.zeros(E * W + 1, dtype=torch.int64, device=dev)
    slot_gatepos[slot] = order
    return slot_token[:-1].reshape(E, W), slot_gatepos[:-1].reshape(E, W)


def _experts(xs, p, groups):
    """The expert SwiGLU on the ``[El * C, d]`` slot rows, one C-row
    block per expert: ``[El*C, d] @ [El, d, ffe]``."""
    g = F.silu(SegmentMatmulFn.apply(xs, p["moe_gate"], groups))
    u = SegmentMatmulFn.apply(xs, p["moe_up"], groups)
    return SegmentMatmulFn.apply(g * u, p["moe_down"], groups)


def _combine(h2, gates, slot_token, slot_gatepos, ys):
    """Gate-multiply the slot outputs and scatter-add them back to their
    tokens, in f32 as the reference does: ``[T, d]`` f32."""
    T, d = h2.shape
    valid = slot_token >= 0
    gate_per_slot = gates.reshape(-1)[slot_gatepos]             # [E, C] f32
    gate_per_slot = torch.where(valid, gate_per_slot, 0.0)
    ys = ys.float() * gate_per_slot.reshape(-1, 1)
    dest = torch.where(valid, slot_token, T).reshape(-1)
    out = torch.zeros((T + 1, d), dtype=torch.float32, device=h2.device)
    return out.index_add_(0, dest, ys)[:T]


def _gather_slots(h2, slot_token):
    valid = (slot_token >= 0).reshape(-1, 1)
    # index_select: its gradient is one index_add_ (the indexing
    # gradient, a sort, took 17 ms a layer at granite-moe's width)
    xs = h2.index_select(0, slot_token.clamp(min=0).reshape(-1))
    return torch.where(valid, xs, 0.0)


def moe_mlp(cfg, h: torch.Tensor, p: dict, tp: TensorParallel = LOCAL):
    """h ``[B, S, d]`` -> (out ``[B, S, d]``, aux loss scalar).

    ``tp`` is the rank's layout (``layers.TensorParallel``; ``LOCAL``:
    one process).  On a model mesh ``h`` is the rank's share of the
    microbatch (``B`` of the global batch's rows; the whole sequence),
    alike on every model rank, ``p`` holds the rank's pieces of the
    weights, and every model rank routes alike (the router is
    replicated).  Three statistics are global over the data axes, as in
    the reference: the capacity ``C = capacity(cfg, T)`` of the global
    token count ``T``; a token's slot, its position in the global token
    order (data rank ``r``'s tokens after those of ranks below ``r``: an
    exclusive prefix of the per-expert counts over the data ranks); and
    the Switch aux, formed from the global ``f`` (``route``'s own aux is
    that of the rank's tokens and is used only on one data rank).  A
    rank's tokens fill slots ``[prefix, prefix + count)`` of each
    expert, so its table holds that window alone, as wide as its fullest
    expert's (a host sync): the grouped GEMM runs on the rank's tokens,
    not on the other ranks' empty slots (on meta tensors, which hold no
    counts, the table is the reference's static ``C`` wide).  The experts
    are sharded over ``"model"`` (EP): the rank runs the grouped GEMM over
    its ``E_pad / n_model`` experts only.

    On a mesh the out is the rank's part of the sum over ``"model"`` (f32
    where there are several model ranks) and the aux its part of the sum
    over the data axes.
    """
    B, S, d = h.shape
    T = B * S
    h2 = h.reshape(T, d)
    h2r = tp.rep(h2)
    gates, experts, aux = route(cfg, h2r, p["router"])
    sharded = tp.shards("moe_gate")
    El = p["moe_gate"].shape[0]
    lo = tp.model_rank * El if sharded else 0
    C = capacity(cfg, T * tp.n_data)
    prefix = width = None
    if tp.n_data > 1 and experts.is_meta:
        # no values to read: the reference's static width, the capacity
        every = all_gather_dim(experts.new_empty((1, cfg.e_pad)), 0, tp.data)
        prefix, width = every[0], C
        f = every.sum(0)[:cfg.n_experts].float()
        aux = cfg.n_experts * (f * router_probs(h2r, p["router"]).sum(0)
                               ).sum()
    elif tp.n_data > 1:
        counts = torch.bincount(experts.reshape(-1), minlength=cfg.e_pad)
        every = all_gather_dim(counts[None], 0, tp.data)    # [n_data, E]
        prefix = every[:tp.data_rank].sum(0)
        T_all = T * tp.n_data
        f = every.sum(0)[:cfg.n_experts].float() / (T_all * cfg.top_k)
        probs = router_probs(h2r, p["router"])                 # [T, E]
        aux = cfg.n_experts * (f * probs.sum(0)).sum() / T_all
        kept = torch.minimum(counts, (C - prefix).clamp(min=0))[lo:lo + El]
        width = max(8, -(-int(kept.max()) // 8) * 8)
    slot_token, slot_gatepos = dispatch_tables(cfg, experts, C, prefix, lo,
                                               lo + El, width)
    xs = _gather_slots(tp.into(h2, sharded), slot_token)    # [El*W, d]
    groups = torch.arange(El, dtype=torch.int32, device=h.device)
    ys = _experts(xs, p, groups)
    if sharded:          # each rank's slots take a part of the gradient
        gates = copy_to(gates, tp.model)
    out = tp.part(tp.out(_combine(h2, gates, slot_token, slot_gatepos, ys),
                         sharded), h.dtype)
    if cfg.n_shared_experts > 0:
        sh = tp.shards("shared_gate")
        out = out + tp.out(tp.swiglu(tp.into(h2, sh), p["shared_gate"],
                                     p["shared_up"], p["shared_down"]), sh)
    return out.reshape(B, S, d), aux

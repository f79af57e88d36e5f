"""Decoder-only LM: dense + MoE, GQA, local/global alternation, KV cache.

The port of ``repro.models.transformer``: ``forward`` and ``train_loss``
over the reference's parameter tree, and ``TransformerLM`` for serving
(``forward``, ``prefill`` and ``decode_step``).  They compute what the
reference's entry points of the same names compute, on the card (the
attention of every prefill and forward layer goes through the
hand-written flash-attention kernel, the MoE expert products through the
grouped-GEMM kernel) or, for CPU tensors, with the kernels' plain
versions.

The parameter tree is the reference's ``init_params`` layout: ``embed``,
``final_norm``, ``unembed`` (untied configs) and ``layers``, a dict of
tensors stacked on a leading ``[L]`` axis, so its leaves line up with the
reference's in jax's order (``train/pytree.py``) and checkpoints cross
between the packages.  Where the reference scans over ``[L]``, the port
loops in Python; ``TransformerLM`` holds one ``Block`` per layer
(``TransformerLM.from_tree`` builds one over views of a tree).  The
weights keep the reference's ``[in, out]`` orientation, so ``x @ w`` is
the same product.  Numbers that have to match the reference exactly:

* layer ``i`` attends through ``layer_windows(cfg)[i]``: with
  ``alt_local_global`` even layers are local (the sliding window) and
  odd layers global, as the reference's two-layer scan body;
* every weight is rounded to the compute dtype before it is used (the
  reference's ``cast_for_compute``), norm scales included;
* scalars are rounded to the compute dtype before they multiply, as
  JAX's weak typing does: the embedding scale ``sqrt(d_model)`` (68.0 in
  bf16 for Gemma-2-27B) and the query pre-scale
  ``query_scale * sqrt(head_dim)`` (0.94140625 in bf16);
* the final softcap runs on f32 logits, prefill returns the logits of
  the last position only, and its cache is zero past the prompt.

Training differentiates ``forward`` with torch autograd: the attention
through ``attention.FlashAttentionFn`` (the kernel forward, the torch-op
``attention_blockwise`` backward), the expert products through
``moe.SegmentMatmulFn``.  With ``cfg.remat`` each layer group (the
reference's scan body: one layer, or a local and a global one) runs
under ``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``;
its weights are cast to the compute dtype inside the group, so only one
group's cast copy lives at a time.

MoE configs (``n_experts > 0``) replace the dense MLP of every layer by
``moe.moe_mlp``; ``forward`` returns the aux loss summed over layers, as
the reference does, and ``prefill`` / ``decode_step`` drop it.

On a model mesh (``forward`` / ``train_loss`` with ``mesh=``, one
process per rank, ``launch.mesh.ModelMesh``) each rank holds its pieces
of the tree as ``dist.sharding.lm_param_shardings`` places them and its
share of the batch's rows; its ``layout`` (``layers.TensorParallel``)
says how the one layer code runs them (what GSPMD derives from the same
specs for the reference), and without a mesh every collective of it is
the identity:

* ``wq`` / ``wk`` / ``wv`` column-parallel, the flash kernel on each
  rank's own heads (a GQA group stays whole: where the specs split a
  k / v projection's columns but not whole kv heads, its output is
  gathered over ``"model"`` first); ``wo`` and ``w_down`` /
  ``shared_down`` row-parallel, their pieces summed over ``"model"`` in
  f32 and rounded once (``TensorParallel.rows``), as one process's
  product rounds once; the experts sharded over ``"model"``
  (``moe.moe_mlp``); the embedding and unembedding over the vocabulary
  where it divides (``dist.collectives.embedding_partial``;
  ``layers.softmax_xent``'s vocab-parallel loss), else replicated;
  norms and the router replicated.
* ``cfg.residual_spec`` set (the reference's sequence parallelism,
  ``(data axes, "model", None)``): the residual stream is sharded over
  ``"model"`` along the sequence.  Each block's normed input is
  all-gathered over ``"model"`` (the reference's ``_h_gather``) and its
  row-parallel output reduce-scattered instead of all-reduced.  The
  reference's ``_qkv_constraints`` are layout hints to GSPMD that
  change no value and have no counterpart.
* Query heads that do not divide over the model ranks (granite-moe's 24
  over 16) run the attention block whole on every model rank: q / k / v
  / ``wo`` gathered over ``"model"`` (``coll.gather_whole``: each rank's
  piece takes its chunk of the gradient), rank 0's output joining the
  sum over ``"model"``.
* Serving on a mesh (``prefill`` / ``decode_step`` with ``mesh=``, the
  reference's prefill and decode cells): prefill runs the same layer
  code and returns the rows' logits over the whole vocabulary and the
  rank's piece of the cache; decode takes the flash-decoding layout
  (the cache's sequence over ``"model"``, or over the data and model
  axes for a batch too small to split), each layer combining the ranks'
  softmax statistics (``attention.attention_decode_sharded``).
* The loss is the global one (``layers.softmax_xent`` with ``mesh``;
  the MoE aux from global statistics), and each rank's gradient is its
  part of the global gradient: summed over the data axes
  (``train.steps``) it is the reference's.  A leaf replicated over
  ``"model"`` gets its full gradient on every model rank.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..dist import collectives as coll
from ..dist.sharding import data_axes, lm_param_shardings, n_model
from .attention import attention_decode, attention_flash, attention_naive
from .layers import (LOCAL, TensorParallel, apply_rope, cast_for_compute,
                     rms_norm, softcap, softmax_xent)
from .moe import moe_mlp


@dataclass(frozen=True)
class LMConfig:
    """A copy of ``repro.models.transformer.LMConfig`` (same fields and
    defaults, so a config file reads the same in both packages)."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                   # 0 -> d_model // n_heads
    # MoE (n_experts == 0 -> dense)
    n_experts: int = 0
    n_experts_padded: int = 0
    top_k: int = 0
    d_expert: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # gemma2-style features
    sliding_window: int = 0             # >0 enables local attention
    alt_local_global: bool = False      # alternate local/global layers
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    query_scale: float = 0.0            # 0 -> 1/sqrt(head_dim)
    scale_embed: bool = False           # x *= sqrt(d_model) after embed
    post_norms: bool = False            # extra post-attn/post-mlp norms
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    # execution
    attn_impl: str = "flash"            # flash | naive | pallas
    remat: bool = True
    residual_spec: tuple | None = None
    family: str = "lm"

    def __post_init__(self):
        assert self.n_heads % self.n_kv_heads == 0
        if self.alt_local_global:
            assert self.n_layers % 2 == 0

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def e_pad(self) -> int:
        return max(self.n_experts_padded, self.n_experts)

    def _counts(self, n_routed: int) -> int:
        d = self.d_model
        attn = d * self.hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.is_moe:
            mlp = (d * self.n_experts
                   + 3 * d * self.d_expert * (n_routed
                                              + self.n_shared_experts))
        else:
            mlp = 3 * d * self.d_ff
        norms = d * (4 if self.post_norms else 2)
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + mlp + norms) + emb + d

    def param_count(self) -> int:
        """The reference's count (the pad experts left out)."""
        return self._counts(self.n_experts)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        return self._counts(self.top_k if self.is_moe else 0)


def _slots(cfg: LMConfig) -> tuple[int, ...]:
    """The windows of one layer group (the reference's scan body)."""
    if cfg.alt_local_global and cfg.sliding_window > 0:
        return (cfg.sliding_window, 0)         # local, then global
    if cfg.sliding_window > 0:
        return (cfg.sliding_window,)
    return (0,)


def layer_windows(cfg: LMConfig) -> tuple[int, ...]:
    """The attention window of every layer (0 = global)."""
    slots = _slots(cfg)
    return tuple(slots[i % len(slots)] for i in range(cfg.n_layers))


def layer_shapes(cfg: LMConfig) -> dict[str, tuple[int, ...]]:
    """Name -> shape of one layer's weights (the reference's names)."""
    d, hd, Hq, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    shapes = dict(attn_norm=(d,), wq=(d, Hq * hd), wk=(d, Hkv * hd),
                  wv=(d, Hkv * hd), wo=(Hq * hd, d), mlp_norm=(d,))
    if cfg.post_norms:
        shapes.update(post_attn_norm=(d,), post_mlp_norm=(d,))
    if cfg.is_moe:
        E, ffe = cfg.e_pad, cfg.d_expert
        shapes.update(router=(d, cfg.n_experts), moe_gate=(E, d, ffe),
                      moe_up=(E, d, ffe), moe_down=(E, ffe, d))
        if cfg.n_shared_experts > 0:
            ffs = ffe * cfg.n_shared_experts
            shapes.update(shared_gate=(d, ffs), shared_up=(d, ffs),
                          shared_down=(ffs, d))
    else:
        shapes.update(w_gate=(d, cfg.d_ff), w_up=(d, cfg.d_ff),
                      w_down=(cfg.d_ff, d))
    return shapes


def abstract_params(cfg: LMConfig, dtype=torch.float32) -> dict:
    """The parameter tree's shapes as ``meta`` tensors (no storage): the
    counterpart of the reference's ``abstract_params``, what the
    sharding builders read."""
    L, d = cfg.n_layers, cfg.d_model
    meta = dict(dtype=dtype, device="meta")
    params = dict(embed=torch.empty((cfg.vocab, d), **meta),
                  final_norm=torch.empty((d,), **meta),
                  layers={name: torch.empty((L,) + shape, **meta)
                          for name, shape in layer_shapes(cfg).items()})
    if not cfg.tie_embeddings:
        params["unembed"] = torch.empty((d, cfg.vocab), **meta)
    return params


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to ``like``'s dtype (JAX's weak-typed scalar),
    filled on ``like``'s device: no host-to-device copy, which would make
    the host wait for the card."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


# -- the pieces of a layer: functions of (cfg, x, weights, layout) -----------
def layout(cfg: LMConfig, mesh, rows_split: bool = True) -> TensorParallel:
    """How a rank of ``mesh`` runs the layer pieces (``LOCAL`` without
    a mesh): the placements of ``lm_param_shardings``, sequence parallel
    where ``cfg.residual_spec`` is set.  Query heads that do not divide
    over the model ranks (granite-moe's 24 over 16) run the attention
    block whole on every model rank (``TensorParallel.whole``).
    ``rows_split=False``: every data rank holds the whole batch."""
    if mesh is None:
        return LOCAL
    return TensorParallel(mesh, lm_param_shardings(cfg, abstract_params(cfg),
                                                   mesh),
                          sp=cfg.residual_spec is not None,
                          whole=cfg.n_heads % n_model(mesh) != 0,
                          rows_split=rows_split)


def _embed(cfg, embed, tokens, dtype, tp=LOCAL):
    if tp.vocab_embed:
        x = tp.combine(coll.embedding_partial(embed, tokens, tp.mesh))
    else:
        x = tp.split(embed[tokens])
    x = x.to(dtype)
    if cfg.scale_embed:
        x = x * _scalar(cfg.d_model ** 0.5, x)
    return x


def _kv(cfg, tp, h, w, name):
    """The keys or values ``[B, S, kv heads, hd]`` of this rank's query
    heads, and, where those are not the rank's piece of the cache (the
    reference's cache specs: kv heads over ``"model"`` where they
    divide, else every kv head), every kv head (else None)."""
    B, S, _ = h.shape
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    sharded = tp.shards(name)
    if tp.whole:
        return (tp.rep(h) @ tp.gathered(w, name, -1)).reshape(B, S, Hkv,
                                                              hd), None
    if tp.n == 1 or (sharded and Hkv % tp.n == 0):   # whole kv heads
        return (tp.into(h, sharded) @ w).reshape(B, S, -1, hd), None
    if sharded:                      # columns split inside a kv head
        full = coll.gather_from(tp.col(h) @ w, -1, tp.model)
    else:
        full = coll.copy_to(tp.rep(h) @ w, tp.model)
    full = full.reshape(B, S, Hkv, hd)
    G, hq = Hq // Hkv, Hq // tp.n
    first = tp.model_rank * hq
    if hq % G == 0:
        return full[:, :, first // G:(first + hq) // G].contiguous(), full
    if G % hq == 0:
        return full[:, :, first // G:first // G + 1].contiguous(), full
    heads = torch.arange(first, first + hq, device=h.device) // G
    return full.index_select(2, heads), full


def _qkv(cfg, x, p, positions, tp=LOCAL, cache: bool = False):
    """q, k and v of this rank's query heads; with ``cache`` also this
    rank's piece of the cache's k and v (``_kv``)."""
    hd = cfg.hd
    h = tp.enter(rms_norm(x, tp.norm(p["attn_norm"])))
    B, S, _ = h.shape
    if tp.whole:
        q = (tp.rep(h) @ tp.gathered(p["wq"], "wq", -1)).reshape(
            B, S, cfg.n_heads, hd)
    else:
        q = (tp.col(h) @ p["wq"]).reshape(B, S, cfg.n_heads // tp.n, hd)
    kk, k_all = _kv(cfg, tp, h, p["wk"], "wk")
    vv, v_all = _kv(cfg, tp, h, p["wv"], "wv")
    q = apply_rope(q, positions, cfg.rope_theta)
    kk = apply_rope(kk, positions, cfg.rope_theta)
    if cfg.query_scale:                  # fold the custom scale into q
        q = q * _scalar(cfg.query_scale * hd ** 0.5, q)
    if not cache:
        return q, kk, vv
    k_all = kk if k_all is None else apply_rope(k_all, positions,
                                                cfg.rope_theta)
    return q, kk, vv, (k_all, vv if v_all is None else v_all)


def _attn_out(cfg, x, o, p, tp=LOCAL):
    o = o.reshape(*o.shape[:2], -1)
    if tp.whole:                    # repeated: rank 0's joins the sum
        o = tp.out(o @ tp.gathered(p["wo"], "wo", 0), False)
    else:
        o = tp.rows(o, p["wo"])
    o = tp.combine(o).to(x.dtype)
    if cfg.post_norms:
        o = rms_norm(o, tp.norm(p["post_attn_norm"]))
    return x + o


def _mlp(cfg, x, p, tp=LOCAL):
    """The MLP half of a layer; returns the new x and the aux loss (a
    Python 0.0 for dense layers)."""
    h = tp.enter(rms_norm(x, tp.norm(p["mlp_norm"])))
    if cfg.is_moe:
        o, aux = moe_mlp(cfg, h, p, tp)
    else:
        sh = tp.shards("w_gate")
        o = tp.out(tp.swiglu(tp.into(h, sh), p["w_gate"], p["w_up"],
                             p["w_down"]), sh)
        aux = 0.0
    o = tp.combine(o).to(x.dtype)
    if cfg.post_norms:
        o = rms_norm(o, tp.norm(p["post_mlp_norm"]))
    return x + o, aux


def _layer(cfg, x, p, window, positions, tp=LOCAL, cache: bool = False):
    """One prefill/forward layer on weights ``p`` in the compute dtype;
    returns the new x, with ``cache`` this rank's piece of the cache's k
    and v (else None), and the layer's aux loss."""
    if cache:
        q, kk, vv, kv = _qkv(cfg, x, p, positions, tp, cache=True)
    else:
        (q, kk, vv), kv = _qkv(cfg, x, p, positions, tp), None
    if cfg.attn_impl == "flash":
        o = attention_flash(q, kk, vv, causal=True, window=window,
                            attn_softcap=cfg.attn_softcap)
    else:
        o = attention_naive(q, kk, vv, causal=True, window=window,
                            attn_softcap=cfg.attn_softcap,
                            q_positions=positions, kv_positions=positions)
    x, aux = _mlp(cfg, _attn_out(cfg, x, o, p, tp), p, tp)
    return x, kv, aux


def _logits(cfg, x, p, tp=LOCAL):
    """Final norm and unembedding; ``p`` holds ``final_norm``, ``embed``
    and ``unembed`` (None or absent when tied), cast here to x's
    dtype."""
    dtype = x.dtype
    x = tp.enter(rms_norm(x, tp.norm(p["final_norm"].to(dtype))))
    w = p.get("unembed")
    w = (p["embed"].T if w is None else w).to(dtype)
    logits = tp.into(x, tp.vocab_logits) @ w
    if cfg.final_softcap:
        logits = softcap(logits.float(), cfg.final_softcap)
    return logits


def _layer_group(cfg, tp, windows, positions, dtype, x, group):
    """One layer group (the reference's scan body) on weights in their
    storage dtype: ``(x, the group's aux)``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, window in zip(group, windows):
        x, _, a = _layer(cfg, x, cast_for_compute(p, dtype), window,
                         positions, tp)
        aux = aux + a
    return x, aux


def _forward(cfg, top, layers, tokens, dtype, tp=LOCAL):
    """``forward`` over ``top`` (``embed``, ``final_norm``, ``unembed``)
    and one weight dict per layer; each group under
    ``torch.utils.checkpoint`` when ``cfg.remat`` and autograd records.
    The aux is summed over the data ranks (identity backward)."""
    S = tokens.shape[1]
    if cfg.residual_spec is not None and tp.mesh is None:
        raise ValueError(f"{cfg.name}: residual_spec shards the residual "
                         "stream over a model mesh: pass mesh=")
    if tp.sp and S % tp.n:
        raise ValueError(f"sequence parallelism: {S} positions do not "
                         f"divide over {tp.n} model ranks")
    x = _embed(cfg, top["embed"], tokens, dtype, tp)
    positions = torch.arange(S, device=x.device)
    g = len(_slots(cfg))
    windows = layer_windows(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, cfg.n_layers, g):
        body = partial(_layer_group, cfg, tp, windows[i:i + g], positions,
                       dtype)
        if cfg.remat and torch.is_grad_enabled():
            x, a = checkpoint(body, x, layers[i:i + g], use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = body(x, layers[i:i + g])
        aux = aux + a
    return _logits(cfg, x, top, tp), coll.reduce_from(aux, tp.data)


# -- the functional entry points over the parameter tree ---------------------
def forward(cfg: LMConfig, params: dict, tokens: torch.Tensor,
            compute_dtype=torch.bfloat16, mesh=None):
    """tokens ``[B, S]`` -> (logits ``[B, S, V]``, aux loss: the sum over
    layers, f32, 0 for a dense LM), differentiable in every leaf of the
    parameter tree (f32 leaves, bf16 compute by default).

    With ``mesh`` (one rank of a ``launch.mesh.ModelMesh``) ``params``
    holds this rank's pieces of the tree (``lm_param_shardings``) and
    ``tokens`` its share of the batch's rows; the logits are this rank's
    rows and, where the vocabulary is sharded, its columns; the aux is
    the global one (summed over the data ranks, identity backward)."""
    return _forward(cfg, params, _unstack(cfg, params), tokens,
                    compute_dtype, layout(cfg, mesh))


def _unstack(cfg, params) -> list:
    """One weight dict per layer, views of the stacked ``[L]`` leaves."""
    stacked = {name: torch.unbind(w) for name, w in params["layers"].items()}
    return [{name: w[i] for name, w in stacked.items()}
            for i in range(cfg.n_layers)]


def train_loss(cfg: LMConfig, params: dict, batch: dict,
               compute_dtype=torch.bfloat16, mesh=None) -> torch.Tensor:
    """batch = ``{tokens [B, S], labels [B, S], mask [B, S]}`` -> the
    scalar loss: mean cross-entropy (f32) plus ``router_aux_coef * aux /
    n_layers``.  With ``mesh`` as in ``forward``: the global loss, its
    gradient this rank's part of the global one."""
    tp = layout(cfg, mesh)
    logits, aux = _forward(cfg, params, _unstack(cfg, params),
                           batch["tokens"], compute_dtype, tp)
    loss = softmax_xent(logits, batch["labels"], batch.get("mask"),
                        mesh=mesh, vocab_sharded=tp.vocab_logits)
    return loss + cfg.router_aux_coef * aux / max(cfg.n_layers, 1)


def _serving_layout(cfg, mesh, rows_split: bool = True) -> TensorParallel:
    if cfg.residual_spec is not None:
        raise NotImplementedError(
            f"{cfg.name}: residual sharding is not ported to serving "
            "(forward / train_loss take it with mesh=)")
    return layout(cfg, mesh, rows_split)


def _full_vocab(logits, tp):
    """This rank's logits over the whole vocabulary."""
    if tp.vocab_logits:
        return coll.all_gather_dim(logits, -1, tp.model)
    return logits


def _prefill(cfg, top, layers, tokens, cache_len, dtype, tp=LOCAL):
    B, S = tokens.shape
    if cache_len < S:
        raise ValueError(f"cache_len {cache_len} < prompt length {S}")
    x = _embed(cfg, top["embed"], tokens, dtype, tp)
    positions = torch.arange(S, device=x.device)
    k_cache = v_cache = None
    for i, (p, w) in enumerate(zip(layers, layer_windows(cfg))):
        x, (kk, vv), _ = _layer(cfg, x, cast_for_compute(p, dtype), w,
                                positions, tp, cache=True)
        if k_cache is None:
            shape = (cfg.n_layers, B, cache_len) + tuple(kk.shape[2:])
            k_cache = torch.zeros(shape, dtype=dtype, device=x.device)
            v_cache = torch.zeros(shape, dtype=dtype, device=x.device)
        k_cache[i, :, :S] = kk
        v_cache[i, :, :S] = vv
    logits = _full_vocab(_logits(cfg, x[:, -1:], top, tp), tp)
    return logits, dict(k=k_cache, v=v_cache, kv_len=S)


def _position(kv_len, S: int) -> int:
    """The decode position: ``kv_len`` as an int; a meta tensor has no
    value, so the step is taken at a full cache (``S - 1``), as the
    reference's static shapes compute every slot."""
    if isinstance(kv_len, torch.Tensor) and kv_len.is_meta:
        return S - 1
    return int(kv_len)


def _decode(cfg, top, layers, cache, tokens, dtype):
    """One process's decode step (``TransformerLM.decode_step``)."""
    k_cache, v_cache = cache["k"], cache["v"]
    pos = _position(cache["kv_len"], k_cache.shape[2])
    if pos >= k_cache.shape[2]:
        raise ValueError(f"cache full: kv_len {pos} == cache_len")
    x = _embed(cfg, top["embed"], tokens, dtype)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    for i, (p, w) in enumerate(zip(layers, layer_windows(cfg))):
        p = cast_for_compute(p, dtype)
        q, kk, vv = _qkv(cfg, x, p, positions)
        k_cache[i, :, pos] = kk[:, 0]
        v_cache[i, :, pos] = vv[:, 0]
        lo = max(0, pos + 1 - w) if w > 0 else 0
        o = attention_decode(q, k_cache[i, :, lo:pos + 1],
                             v_cache[i, :, lo:pos + 1],
                             kv_len=pos + 1 - lo, window=w,
                             attn_softcap=cfg.attn_softcap)
        x, _ = _mlp(cfg, _attn_out(cfg, x, o, p), p)
    logits = _logits(cfg, x, top)
    return logits, dict(k=k_cache, v=v_cache, kv_len=pos + 1)


def _decode_sharded(cfg, top, layers, cache, tokens, dtype, mesh,
                    seq_axes):
    """The flash-decoding layout: this rank's cache holds positions
    ``[r S_loc, (r + 1) S_loc)`` of every kv head (``r`` its coordinate
    over ``seq_axes``).  Each layer gathers the token's q and k / v over
    ``"model"`` (every head), the rank owning the position writes it,
    and ``attention_decode_sharded`` combines the ranks' softmax
    statistics and outputs; this rank's query heads then go through the
    row-parallel ``wo`` (all of them where the attention runs whole)."""
    from .attention import attention_decode_sharded
    seq_axes = tuple(seq_axes)
    tp = _serving_layout(cfg, mesh,
                         rows_split=not set(seq_axes) & set(data_axes(mesh)))
    group, r = mesh.group(seq_axes), mesh.coord(seq_axes)
    k_cache, v_cache = cache["k"], cache["v"]
    S_loc = k_cache.shape[2]
    S = S_loc * mesh.extent(seq_axes)
    pos = _position(cache["kv_len"], S)
    if pos >= S:
        raise ValueError(f"cache full: kv_len {pos} == cache_len")
    owner, slot = divmod(pos, S_loc)
    hq = cfg.n_heads if tp.whole else cfg.n_heads // tp.n
    first = 0 if tp.whole else tp.model_rank * hq
    x = _embed(cfg, top["embed"], tokens, dtype, tp)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    for i, (p, w) in enumerate(zip(layers, layer_windows(cfg))):
        p = cast_for_compute(p, dtype)
        q, _, _, (kk, vv) = _qkv(cfg, x, p, positions, tp, cache=True)
        q = _all_heads(q, cfg.n_heads, tp)
        kk, vv = (_all_heads(t, cfg.n_kv_heads, tp) for t in (kk, vv))
        if r == owner:
            k_cache[i, :, slot] = kk[:, 0]
            v_cache[i, :, slot] = vv[:, 0]
        o = attention_decode_sharded(q, k_cache[i], v_cache[i],
                                     kv_len=pos + 1, offset=r * S_loc,
                                     group=group, window=w,
                                     attn_softcap=cfg.attn_softcap)
        o = o[:, :, first:first + hq]
        x, _ = _mlp(cfg, _attn_out(cfg, x, o, p, tp), p, tp)
    logits = _full_vocab(_logits(cfg, x, top, tp), tp)
    return logits, dict(k=k_cache, v=v_cache, kv_len=pos + 1)


def _all_heads(t, heads: int, tp):
    """``t`` ``[B, 1, h, hd]`` of this rank's heads -> every head."""
    if t.shape[2] == heads:
        return t
    return coll.all_gather_dim(t, 2, tp.model)


@torch.no_grad()
def prefill(cfg: LMConfig, params: dict, tokens: torch.Tensor,
            cache_len: int, compute_dtype=torch.bfloat16, mesh=None):
    """``TransformerLM.prefill`` over the parameter tree (``forward``'s
    layout).  With ``mesh`` (one rank of a ``launch.mesh.ModelMesh``)
    ``params`` holds this rank's pieces (``lm_param_shardings``) and
    ``tokens`` its rows; the layers run as ``forward``'s, and it returns
    the rows' logits over the whole vocabulary and this rank's piece of
    the cache: every position, and the kv heads over ``"model"`` where
    they divide, else all of them (the reference's cache specs)."""
    return _prefill(cfg, params, _unstack(cfg, params), tokens, cache_len,
                    compute_dtype, _serving_layout(cfg, mesh))


@torch.no_grad()
def decode_step(cfg: LMConfig, params: dict, cache: dict,
                tokens: torch.Tensor, compute_dtype=torch.bfloat16,
                mesh=None, seq_axes=("model",)):
    """``TransformerLM.decode_step`` over the parameter tree.  With
    ``mesh``: the flash-decoding layout (``_decode_sharded``), the
    cache's sequence sharded over ``seq_axes`` (``("model",)``, or the
    data and model axes together when the batch is too small to split
    over the data ranks: then every data rank holds every row)."""
    if mesh is None:
        return _decode(cfg, params, _unstack(cfg, params), cache, tokens,
                       compute_dtype)
    return _decode_sharded(cfg, params, _unstack(cfg, params), cache,
                           tokens, compute_dtype, mesh, seq_axes)


class Block(nn.Module):
    """One layer's weights, named as in the reference's ``layers`` dict."""

    def __init__(self, weights: dict[str, torch.Tensor]):
        super().__init__()
        for name, w in weights.items():
            self.register_parameter(name, nn.Parameter(w,
                                                       requires_grad=False))


class TransformerLM(nn.Module):
    """A decoder LM (dense or MoE) for serving; build it with
    ``convert.lm_from_numpy``, ``convert.init_lm`` or ``from_tree``."""

    def __init__(self, cfg: LMConfig, embed: torch.Tensor,
                 final_norm: torch.Tensor, layers: list[dict],
                 unembed: torch.Tensor | None = None):
        super().__init__()
        if cfg.residual_spec is not None:
            raise NotImplementedError(
                f"{cfg.name}: residual sharding is not ported to serving "
                "(it runs on one device; forward / train_loss take it "
                "with mesh=)")
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{cfg.name}: {len(layers)} layers given, "
                             f"config has {cfg.n_layers}")
        if (unembed is None) != cfg.tie_embeddings:
            raise ValueError(f"{cfg.name}: tie_embeddings="
                             f"{cfg.tie_embeddings} but unembed "
                             f"{'missing' if unembed is None else 'given'}")
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.unembed = (None if unembed is None
                        else nn.Parameter(unembed, requires_grad=False))
        self.layers = nn.ModuleList(Block(w) for w in layers)
        self.windows = layer_windows(cfg)

    @classmethod
    def from_tree(cls, cfg: LMConfig, params: dict) -> "TransformerLM":
        """A model over views of a parameter tree (``forward``'s layout),
        no copy: it serves the weights a training run holds.  The
        optimizer returns new tensors each step, so build it again from
        the tree a step returns."""
        lay = params["layers"]
        layers = [{name: w[i].detach() for name, w in lay.items()}
                  for i in range(cfg.n_layers)]
        unembed = params.get("unembed")
        return cls(cfg, params["embed"].detach(),
                   params["final_norm"].detach(), layers,
                   None if unembed is None else unembed.detach())

    def _top(self) -> dict:
        return dict(embed=self.embed, final_norm=self.final_norm,
                    unembed=self.unembed)

    # -- entry points --------------------------------------------------------
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, compute_dtype=torch.bfloat16):
        """tokens ``[B, S]`` -> (logits ``[B, S, V]``, aux loss: the sum
        over layers, f32, 0 for a dense LM)."""
        return _forward(self.cfg, self._top(), self._layer_weights(),
                        tokens, compute_dtype)

    def _layer_weights(self) -> list:
        return [dict(blk.named_parameters()) for blk in self.layers]

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache_len: int,
                compute_dtype=torch.bfloat16, mesh=None):
        """Run the prompt; return (last-position logits ``[B, 1, V]``,
        cache).

        Cache layout (the reference's): ``k``/``v`` ``[L, B, cache_len,
        Hkv, hd]`` in the compute dtype, zero past the prompt, and
        ``kv_len`` = S positions written (an int).  With ``mesh`` the
        model holds one rank's pieces: the module-level ``prefill``.
        """
        return _prefill(self.cfg, self._top(), self._layer_weights(),
                        tokens, cache_len, compute_dtype,
                        layout(self.cfg, mesh))

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor,
                    compute_dtype=torch.bfloat16, mesh=None,
                    seq_axes=("model",)):
        """One decode step: tokens ``[B, 1]`` at position ``kv_len``.

        Writes the new keys and values into slot ``kv_len`` of
        ``cache["k"]`` / ``cache["v"]`` **in place** (the reference
        returns updated copies) and returns (logits ``[B, 1, V]``, a
        cache dict over the same tensors with ``kv_len + 1``).  Each layer
        attends only to the slots its mask can see,
        ``[max(0, kv_len + 1 - window), kv_len]``: the other slots get
        weight ``exp(-2^30 - m) = 0`` in the reference.  With ``mesh``
        the model holds one rank's pieces: the module-level
        ``decode_step``.
        """
        if mesh is None:
            return _decode(self.cfg, self._top(), self._layer_weights(),
                           cache, tokens, compute_dtype)
        return _decode_sharded(self.cfg, self._top(), self._layer_weights(),
                               cache, tokens, compute_dtype, mesh, seq_axes)

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
import torch.distributed as dist
import torch.nn.functional as F

from ..dist import collectives as coll
from ..dist.sharding import data_axes, n_data, n_model


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
                 z_loss: float = 0.0, *, mesh=None,
                 vocab_sharded: bool = False) -> torch.Tensor:
    """Mean cross-entropy in f32, optional z-loss ``z_loss * lse^2``.

    logits ``[..., V]`` (any float dtype); labels int ``[...]``; mask
    broadcastable to labels (1 = count the position), averaged over
    ``max(sum(mask), 1)``.

    With ``mesh`` (one rank of a ``launch.mesh.ModelMesh``) the rows are
    this rank's share of the batch and the loss is the global one: the
    sum over every data rank's positions over the global mask count
    (both summed over the data axes; averaging each rank's mean would
    weigh a rank by its mask count).  Its gradient is that of this
    rank's part of the sum (``reduce_from``: identity backward), so the
    gradients summed over the data ranks are the global loss's.  With
    ``vocab_sharded`` the last axis is this rank's ``V / n_model``
    columns of the vocabulary (rank ``r`` holds ``[r V/n, (r+1) V/n)``):
    the max and the sum of exponentials are reduced over ``"model"`` and
    the target logit comes from the rank that holds it, so no rank holds
    the full ``[..., V]`` logits.
    """
    lf = logits.float()
    if vocab_sharded:
        group = mesh.group("model")
        m = coll.all_reduce(lf.detach().amax(dim=-1), group,
                            dist.ReduceOp.MAX)
        lse = m + torch.log(coll.reduce_from(
            torch.exp(lf - m[..., None]).sum(dim=-1), group))
        lab = labels.long()
        off = mesh.coord("model") * lf.shape[-1]
        here = (lab >= off) & (lab < off + lf.shape[-1])
        ll = torch.take_along_dim(
            lf, torch.where(here, lab - off, 0)[..., None], dim=-1)[..., 0]
        ll = coll.reduce_from(torch.where(here, ll, 0.0), group)
    else:
        lse = torch.logsumexp(lf, dim=-1)
        ll = torch.take_along_dim(lf, labels.long()[..., None],
                                  dim=-1)[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse ** 2
    if mesh is None:
        if mask is None:
            return loss.mean()
        mask = mask.float()
        return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    data = mesh.group(data_axes(mesh))
    if mask is None:
        mask = torch.ones_like(loss)
    mask = mask.float()
    count = coll.all_reduce(mask.sum(), data)
    return coll.reduce_from((loss * mask).sum(), data) / torch.clamp(count,
                                                                min=1.0)


class TensorParallel:
    """How one rank runs the pieces of a transformer layer
    (``transformer``, ``moe``): which leaves the reference's specs
    (``dist.sharding.lm_param_shardings``) shard, the rank's groups and
    coordinates, and the collectives of its layout.  ``LOCAL`` is one
    process: no groups, so every collective is the identity
    (``dist.collectives``), every leaf whole and every product in the
    compute dtype; ``transformer.layout`` builds a mesh rank's.

    A tensor alike on every model rank either feeds computations every
    rank repeats (its gradient is the full one on every rank) or each
    rank's shard of a computation (partial gradients, summed over the
    ranks): ``dist.collectives``' docstring.  The replicated residual
    stream (no SP) gives full gradients; under SP (``sp``: the residual
    stream sharded over ``"model"`` along the sequence) the gathered
    block input ``h`` takes partial ones, its gather's backward being a
    reduce-scatter.  ``into(h, sharded)`` hands ``h`` to a sharded or a
    repeated computation, ``out(o, sharded)`` a block output to the sum
    over ``"model"`` (``combine``).

    ``whole`` (query heads that do not divide over the model ranks) runs
    the attention block whole on every model rank, a repeated
    computation on its weights gathered (``gathered``).  With
    ``rows_split=False`` every data rank holds the whole batch (the
    flash-decoding layout's sequence over the data axes): the data axes
    are a replica, so there is no data group and ``n_data`` is 1."""

    def __init__(self, mesh=None, specs=None, sp: bool = False,
                 whole: bool = False, rows_split: bool = True):
        self.mesh, self.specs, self.sp, self.whole = mesh, specs, sp, whole
        self.sharded, self.vocab_embed, self.vocab_logits = {}, False, False
        self.model = self.data = None
        self.n = self.n_data = 1
        self.model_rank = self.data_rank = 0
        if mesh is None:
            return
        self.sharded = {name: any(a is not None for a in spec)
                        for name, spec in specs["layers"].items()}
        self.vocab_embed = specs["embed"][0] is not None
        self.vocab_logits = (self.vocab_embed if "unembed" not in specs
                             else specs["unembed"][1] is not None)
        self.model, self.n = mesh.group("model"), n_model(mesh)
        self.model_rank = mesh.coord("model")
        if rows_split:
            self.data = mesh.group(data_axes(mesh))
            self.n_data = n_data(mesh)
            self.data_rank = mesh.coord(data_axes(mesh))

    def shards(self, name: str) -> bool:
        """Whether the specs shard layer leaf ``name``."""
        return self.sharded.get(name, False)

    def gathered(self, w, name: str, dim: int):
        """Layer leaf ``name`` whole on every model rank (all-gathered
        along ``dim`` where the specs shard it), for a computation every
        rank repeats: each rank's piece takes its chunk of the
        gradient."""
        if not self.shards(name):
            return w
        return coll.gather_whole(w, dim, self.model)

    def col(self, h):
        """``h`` for a computation sharded over ``"model"``."""
        return h if self.sp else coll.copy_to(h, self.model)

    def rep(self, h):
        """``h`` for a computation every model rank repeats."""
        return coll.first_rank_grad(h, self.model) if self.sp else h

    def into(self, h, sharded: bool):
        return self.col(h) if sharded else self.rep(h)

    def out(self, o, sharded: bool):
        """A block output as this rank's part of the sum over model."""
        return o if sharded else coll.first_rank_value(o, self.model)

    def norm(self, w):
        """A norm weight: under SP it scales this rank's positions only,
        so its gradient is summed over ``"model"``."""
        return coll.copy_to(w, self.model) if self.sp else w

    def enter(self, h):
        """The block input: under SP all-gathered along the sequence."""
        return coll.gather_from(h, 1, self.model) if self.sp else h

    def split(self, x):
        """A whole sequence as the residual stream: this rank's part
        under SP."""
        return coll.split_to(x, 1, self.model) if self.sp else x

    def combine(self, o):
        """The sum over ``"model"`` of a block's partial outputs:
        reduce-scattered along the sequence under SP."""
        if self.sp:
            return coll.reduce_scatter_to(o, 1, self.model)
        return coll.reduce_from(o, self.model)

    def rows(self, x, w):
        """``x @ w`` for a row-parallel weight.  Over several model ranks
        it is one rank's piece, in f32: the pieces are added over the
        ranks in f32 and rounded once, as one process's product rounds
        once (the operands are the compute dtype's values, exact in
        f32).  Over one, the product in the compute dtype."""
        return x.float() @ w.float() if self.n > 1 else x @ w

    def part(self, o, dtype):
        """A block's partial output as ``rows`` leaves it: f32 over
        several model ranks, else rounded to ``dtype`` now."""
        return o if self.n > 1 else o.to(dtype)

    def swiglu(self, x, w_gate, w_up, w_down):
        """``swiglu`` with its down product through ``rows``."""
        return self.rows(F.silu(x @ w_gate) * (x @ w_up), w_down)


LOCAL = TensorParallel()

"""Collectives of the port's distribution layer (the port's copy of
``repro.dist.collectives``).

* The estimator mesh's shard index (``folded_axis_index``) and the exact
  int64 combine of the engine's shard sums (``combine``): one process,
  the counterpart of the engine's ``jax.lax.psum``.
* The model side, one process per rank on ``torch.distributed``: the
  plain collectives along a dimension (``all_gather_dim``,
  ``reduce_scatter_dim``), the reference's ``psum_chunked`` and
  ``sharded_embedding_lookup``, and the collectives autograd
  differentiates, in Megatron's pairs (what GSPMD inserts for the
  reference):

  ======================  ==========================  ====================
  op                      forward                     backward
  ======================  ==========================  ====================
  ``copy_to``             identity                    all-reduce
  ``reduce_from``         all-reduce                  identity
  ``gather_from``         all-gather along ``dim``    reduce-scatter
  ``reduce_scatter_to``   reduce-scatter along dim    all-gather
  ``split_to``            this rank's chunk of dim    all-gather
  ``gather_whole``        all-gather along ``dim``    this rank's chunk
  ``first_rank_grad``     identity                    rank 0 keeps the
                                                      gradient, others 0
  ``first_rank_value``    rank 0 keeps the value,     identity
                          others 0
  ``psum``                all-reduce                  all-reduce
  ``divide_grad``         identity                    divided by ``n``
  ``ppermute``            shift along the group       shift back
  ======================  ==========================  ====================

  A tensor that every rank of a group holds alike is *replicated*; its
  gradient is either the full gradient on every rank (the tensor feeds
  computations that every rank repeats) or a *partial* one, summed over
  the ranks (it feeds each rank's own shard of a computation).
  ``copy_to`` turns full into partial at the entry of a sharded
  computation, ``first_rank_grad`` partial into full at the entry of a
  repeated one; ``first_rank_value`` lets a repeated result join a sum
  over the ranks once.  With one rank in the group every op is the
  identity.

  ``psum`` and ``divide_grad`` are shard_map's transposes, for the
  edge-parallel GNN (``models.gnn``, ``dist.gnn_sharded``): a psum
  transposes to a psum, and a loss that every rank of ``n`` holds whole
  hands each ``1/n`` of its gradient, so that the step's sum of the
  gradients over the ranks counts the repeated computations once.
  ``pmax`` (no gradient) is the reference's ``pmax``; ``ppermute`` its
  shift of GPipe's stages (``dist.pipeline``).

gloo and NCCL both take every op here for CPU and CUDA tensors (gloo
copies CUDA tensors through the host), so the code does not branch on
the backend, but for ``ppermute``: gloo takes no send / recv of CUDA
tensors, so there the shift is an all-gather that keeps the
predecessor's slice; NCCL (one rank per card) sends and receives.

**Layout groups.**  A ``LayoutGroup`` (the groups of
``launch.mesh.layout_mesh``) stands for a group of ``size`` ranks that
no process joined, seen from its rank 0.  Every collective takes it with
``meta`` tensors only (a real tensor raises) and returns a meta tensor
of the shape the real collective returns, moving nothing; it hands
``(kind, operand bytes, result bytes)`` to each sink in ``LAYOUT_SINKS``
(the roofline's counter, ``roofline.cost.counting``), the kind named as
the reference's HLO names it (``all-gather``, ``all-reduce``,
``reduce-scatter``, ``collective-permute``).  A group of one moves
nothing and records nothing, as a real one.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def folded_axis_index(mesh, axes, coords: dict) -> int:
    """Row-major linear shard index over ``axes`` of the shard at
    per-axis ``coords``: the 0-based index the engine strides its chunk
    round-robin by (shard ``d`` runs offsets ``d + i * D``); with one
    axis it is that axis's coordinate."""
    idx = int(coords[axes[0]])
    for a in axes[1:]:
        idx = idx * int(mesh.shape[a]) + int(coords[a])
    return idx


def combine(parts) -> torch.Tensor:
    """The exact int64 sum of the shards' window sums, copied to the
    host and added in shard order (integer addition: the order cannot
    change the total)."""
    total = None
    for part in parts:
        part = part.to("cpu", torch.int64)
        total = part if total is None else total + part
    return total


# ---------------------------------------------------------------------------
# plain collectives (no gradient)
# ---------------------------------------------------------------------------
class LayoutGroup:
    """A group of ``size`` ranks of a layout mesh, seen from its rank 0:
    no process joined it, and it takes meta tensors only."""

    __slots__ = ("size",)

    def __init__(self, size: int):
        self.size = int(size)

    def __repr__(self) -> str:
        return f"LayoutGroup({self.size})"


# callables ``sink(kind, operand_bytes, result_bytes)`` told of every
# collective on a layout group (``roofline.cost.counting`` adds one)
LAYOUT_SINKS: list = []


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _layout(group, x: torch.Tensor, kind: str, shape) -> torch.Tensor:
    """The layout path of a collective: a meta tensor of ``shape``, the
    call handed to ``LAYOUT_SINKS`` (nothing for a group of one)."""
    if not x.is_meta:
        raise ValueError(f"{kind} over {group}: a layout group takes meta "
                         f"tensors, got one on {x.device}")
    if group.size == 1:
        return x
    out = x.new_empty(shape)
    for sink in LAYOUT_SINKS:
        sink(kind, _nbytes(x), _nbytes(out))
    return out


def _size(group) -> int:
    if isinstance(group, LayoutGroup):
        return group.size
    return dist.get_world_size(group)


def _rank(group) -> int:
    """This process's rank in ``group`` (0 in a layout group)."""
    return 0 if isinstance(group, LayoutGroup) else dist.get_rank(group)


# torch 2.13 names the tensor-in, tensor-out collectives ``*_single`` and
# deprecates the older names, which torch 2.11 (the card's) has alone
_ALL_GATHER = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)
_REDUCE_SCATTER = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in group-rank order."""
    n = _size(group)
    if isinstance(group, LayoutGroup):
        shape = list(x.shape)
        shape[dim] *= n
        return _layout(group, x, "all-gather", shape)
    if n == 1:
        return x
    y = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * y.shape[0],) + tuple(y.shape[1:]),
                      dtype=y.dtype, device=y.device)
    _ALL_GATHER(out, y, group=group)
    return out.movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of the group's ``x``."""
    n = _size(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce-scatter: dimension {x.shape[dim]} does not "
                         f"divide over {n} ranks")
    if isinstance(group, LayoutGroup):
        shape = list(x.shape)
        shape[dim] //= n
        return _layout(group, x, "reduce-scatter", shape)
    if n == 1:
        return x
    y = x.movedim(dim, 0).contiguous()
    out = torch.empty((y.shape[0] // n,) + tuple(y.shape[1:]),
                      dtype=y.dtype, device=y.device)
    _REDUCE_SCATTER(out, y, group=group)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The group's reduction of ``x`` into a new tensor (``x`` kept)."""
    if isinstance(group, LayoutGroup):
        return _layout(group, x, "all-reduce", x.shape)
    if _size(group) == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _size(group)
    if x.shape[dim] % n:
        raise ValueError(f"split: dimension {x.shape[dim]} does not divide "
                         f"over {n} ranks")
    size = x.shape[dim] // n
    return x.narrow(dim, _rank(group) * size, size).contiguous()


# ---------------------------------------------------------------------------
# collectives autograd differentiates
# ---------------------------------------------------------------------------
class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


class _ReduceScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.group), None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _chunk(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.group), None, None


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.dim, ctx.group), None, None


class _FirstRankGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.keep = _rank(group) == 0
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None


class _FirstRankValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return x.clone() if _rank(group) == 0 else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _single(group) -> bool:
    return group is None or _size(group) == 1


def copy_to(x, group):
    """Identity forward, all-reduce backward (Megatron's f)."""
    return x if _single(group) else _CopyTo.apply(x, group)


def reduce_from(x, group):
    """All-reduce forward, identity backward (Megatron's g)."""
    return x if _single(group) else _ReduceFrom.apply(x, group)


def gather_from(x, dim: int, group):
    """All-gather along ``dim`` forward, reduce-scatter backward."""
    return x if _single(group) else _GatherFrom.apply(x, dim, group)


def reduce_scatter_to(x, dim: int, group):
    """Reduce-scatter along ``dim`` forward, all-gather backward."""
    return x if _single(group) else _ReduceScatterTo.apply(x, dim, group)


def split_to(x, dim: int, group):
    """This rank's chunk of ``dim`` forward, all-gather backward."""
    return x if _single(group) else _SplitTo.apply(x, dim, group)


def gather_whole(x, dim: int, group):
    """All-gather along ``dim`` forward; backward keeps this rank's
    chunk of the gradient: a sharded weight made whole for a computation
    every rank of the group repeats (each holds the full gradient)."""
    return x if _single(group) else _GatherWhole.apply(x, dim, group)


def first_rank_grad(x, group):
    """Identity forward; backward keeps the gradient on the group's rank
    0 and gives 0 elsewhere (a full gradient becomes a partial one)."""
    return x if _single(group) else _FirstRankGrad.apply(x, group)


def first_rank_value(x, group):
    """``x`` on the group's rank 0 and 0 elsewhere, identity backward (a
    result every rank repeats joins a sum over the ranks once)."""
    return x if _single(group) else _FirstRankValue.apply(x, group)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _DivideGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Group rank ``i``'s ``x`` on group rank ``(i + shift) % n``."""
    if isinstance(group, LayoutGroup):
        return _layout(group, x, "collective-permute", x.shape)
    n = _size(group)
    me = dist.get_rank(group)
    src = (me - shift) % n
    if dist.get_backend(group) == "gloo":
        return all_gather_dim(x.unsqueeze(0), 0, group)[src].clone()
    out = torch.empty_like(x)
    dst = dist.get_global_rank(group, (me + shift) % n)
    ops = [dist.P2POp(dist.isend, x.contiguous(), dst, group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.shift), None, None


def psum(x, group):
    """All-reduce forward and backward: the reference's ``psum`` under
    ``shard_map``, whose transpose is a psum."""
    return x if _single(group) else _Psum.apply(x, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The group's elementwise max of ``x`` (no gradient)."""
    x = x.detach()
    return x if _single(group) else all_reduce(x, group, dist.ReduceOp.MAX)


def divide_grad(x, n: int):
    """Identity forward; backward divides the gradient by ``n`` (a
    result every one of ``n`` ranks holds whole, as the reference's
    closing ``pmean`` transposes)."""
    return x if n == 1 else _DivideGrad.apply(x, n)


def ppermute(x, group, shift: int = 1):
    """Group rank ``i``'s ``x`` on group rank ``(i + shift) % n`` (the
    reference's ``ppermute`` with ``perm = [(i, (i + shift) % n)]``);
    backward shifts the gradient back."""
    return x if _single(group) else _Ppermute.apply(x, group, shift)


# ---------------------------------------------------------------------------
# the reference's hand-rolled collectives
# ---------------------------------------------------------------------------
def psum_chunked(x: torch.Tensor, axis, n_chunks: int = 1, *,
                 mesh) -> torch.Tensor:
    """The sum of ``x`` over ``mesh.group(axis)`` in ``n_chunks``
    sequential slabs of the flat payload (zero-padded to a multiple of
    ``n_chunks``): equal to one all-reduce element for element, with at
    most one slab in flight."""
    group = mesh.group(axis)
    if n_chunks <= 1:
        return all_reduce(x, group)
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % n_chunks
    chunks = torch.cat([flat, flat.new_zeros(pad)]).reshape(n_chunks, -1)
    out = torch.stack([all_reduce(c, group) for c in chunks])
    return out.reshape(-1)[:n].reshape(x.shape)


def embedding_partial(table_local: torch.Tensor, idx: torch.Tensor, mesh,
                      axis: str = "model") -> torch.Tensor:
    """This rank's part of a lookup in a table row-sharded over
    ``axis``: the rows of the ids in its range, 0 for every other id
    (``-1`` included).  Summed over ``axis`` it is the full lookup."""
    rows = table_local.shape[0]
    offset = mesh.coord(axis) * rows
    here = (idx >= offset) & (idx < offset + rows)
    loc = torch.where(here, idx - offset, 0).long()
    # index_select: its gradient is one index_add_ into the local rows
    out = table_local.index_select(0, loc.reshape(-1)).reshape(
        tuple(idx.shape) + (table_local.shape[1],))
    return torch.where(here[..., None], out, 0.0)


def sharded_embedding_lookup(table_local: torch.Tensor, idx: torch.Tensor,
                             mesh, axis: str = "model") -> torch.Tensor:
    """Gather ``idx`` (``-1`` = padding, a zero row) from a table whose
    rows are sharded over ``axis`` (this rank holds ``table_local``):
    each rank serves the ids in its row range and one all-reduce
    assembles the full ``[*, d]`` result on every rank.  The gradient
    reaches only the local rows (``reduce_from``: identity backward)."""
    return reduce_from(embedding_partial(table_local, idx, mesh, axis),
                       mesh.group(axis))

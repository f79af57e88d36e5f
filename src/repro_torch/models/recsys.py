"""DCN-v2 (Wang et al., arXiv:2008.13535): forward, retrieval, training.

The port of ``repro.models.recsys`` (the JAX package, which stays the
reference).  All sparse tables are concatenated into one ``table
[V_total, d_emb]`` with per-feature row offsets, so the lookup of a batch
is one EmbeddingBag call: on the card the hand-written kernel
(``kernels/embedding_bag``), on the CPU its plain version.  The lookup
is a ``torch.autograd.Function``: its backward is the table's gradient,
a scatter-add (``index_add_``) of the output gradient's rows times each
slot's weight over the ids, in f32 (the reference leaves the same
scatter-add to XLA; no Pallas backward exists).

Model: ``x0 = [dense || concat(bag outputs)]``; cross layers ``x_{l+1} =
x0 * (x_l W + b) + x_l`` (full-rank DCN-v2); an MLP tower; a logit.
``serve_retrieval`` projects the tower output of one query to ``d_emb``
and scores candidate rows of the shared table with one product; the
candidate gather and that product are torch ops, as the reference
computes them outside any kernel.

``params`` is the reference's pytree as torch tensors (``table``,
``cross`` and ``mlp`` lists of ``{W, b}``, ``head`` ``{W, b}``,
``retrieval_proj``), built by ``convert.recsys_from_numpy`` or
``convert.init_recsys``.  Keep it in the compute dtype: the cast at each
call is then a no-op, not a copy of the 2 GB table (training keeps f32
parameters and casts them to bf16 each step, as the reference does).
``batch`` holds torch tensors: ``dense [B, n_dense]``, ``sparse [B,
n_sparse(, bag)]`` (per-feature ids, -1 = padding), for retrieval
``cand_ids``, for training ``label [B]``.

**On a model mesh** (``mesh=``, one rank of a ``launch.mesh.ModelMesh``,
the reference's ``dist.sharding.recsys_param_shardings``): the table is
sharded by rows over ``"model"``, every other leaf replicated, and the
batch is this rank's share of the rows over the data axes (a retrieval
query and its candidates every rank's).  Model rank ``r`` holds rows
``[r V/M, (r+1) V/M)``: it hands the EmbeddingBag kernel its own ids
made local and every other id as ``-1`` (the kernel clamps an id past
its rows to its last row, which a foreign id would otherwise read and,
in backward, write), takes the partial bags in f32 (the kernel's
f32-output mode) and sums them over ``"model"`` before the one rounding
to the table's dtype, so a bag of one id is the one process's row bit
for bit.  The loss is the global batch's mean; each rank's table
gradient lands in its own rows.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..dist import collectives as coll
from ..dist.sharding import data_axes, n_model
from ..kernels.embedding_bag.ops import embedding_bag as _embedding_bag
from .layers import cast_for_compute


@dataclass(frozen=True)
class RecsysConfig:
    """A copy of ``repro.models.recsys.RecsysConfig`` (same fields,
    defaults and properties)."""
    name: str
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    n_cross_layers: int = 3
    mlp: tuple = (1024, 1024, 512)
    table_sizes: tuple = ()        # one vocab size per sparse feature
    bag_size: int = 1              # multi-hot width (1 = one-hot)
    family: str = "recsys"

    @property
    def v_total(self) -> int:
        """Concatenated rows, padded to a 4096 multiple (pad rows are
        never indexed)."""
        v = sum(self.table_sizes)
        return -(-v // 4096) * 4096

    @property
    def d_interact(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim

    def param_count(self) -> int:
        D = self.d_interact
        cross = self.n_cross_layers * (D * D + D)
        dims = (D,) + self.mlp
        mlp = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        head = self.mlp[-1] + 1
        proj = self.mlp[-1] * self.embed_dim
        return self.v_total * self.embed_dim + cross + mlp + head + proj


def table_offsets(cfg: RecsysConfig, device=None) -> torch.Tensor:
    """Row offset of each feature's slice inside the concatenated table
    (int64)."""
    sizes = torch.tensor((0,) + tuple(cfg.table_sizes[:-1]),
                         dtype=torch.int64)
    return torch.cumsum(sizes, 0).to(device)


class EmbeddingBagFn(torch.autograd.Function):
    """The EmbeddingBag kernel (``kernels/embedding_bag``) with the
    table's gradient.  ``idx [N, bag]``, ``weights [N, bag]`` or None.

    Backward: ``d table[idx[i, j]] += weights[i, j] * grad_out[i]`` over
    the slots with ``idx >= 0`` (an id past the table adds to its last
    row, which the forward read), summed in f32 and cast to the table's
    dtype.  The ids and weights get no gradient."""

    @staticmethod
    def forward(ctx, table, idx, weights, out_dtype=None):
        ctx.save_for_backward(idx, weights)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return _embedding_bag(table, idx, weights, out_dtype)

    @staticmethod
    def backward(ctx, grad_out):
        idx, weights = ctx.saved_tensors
        return embedding_bag_grad(grad_out, idx, weights, ctx.table_shape,
                                  ctx.table_dtype), None, None, None


def embedding_bag_grad(grad_out: torch.Tensor, idx: torch.Tensor,
                       weights: torch.Tensor | None, table_shape,
                       table_dtype) -> torch.Tensor:
    """The dense table gradient of ``EmbeddingBagFn`` (one
    ``index_add_``)."""
    V, d = table_shape
    g = grad_out.float()[:, None, :]                          # [N, 1, d]
    if weights is not None:
        g = g * weights.float()[..., None]
    g = g.expand(idx.shape[0], idx.shape[1], d)
    if idx.is_meta:          # no values (the dry run): every slot a row
        ids, rows = idx.reshape(-1), g.reshape(-1, d)
    else:
        valid = idx >= 0
        ids, rows = idx[valid], g[valid]
    acc = torch.zeros((V, d), dtype=torch.float32, device=grad_out.device)
    acc.index_add_(0, ids.long().clamp(max=V - 1), rows)
    return acc.to(table_dtype)


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  weights: torch.Tensor | None = None,
                  out_dtype=None) -> torch.Tensor:
    """idx ``[..., bag]`` (rows of ``table``; -1 = padding) -> the weighted
    sum over the bag ``[..., d]`` in ``out_dtype`` (default the table's),
    through the EmbeddingBag kernel on ``[N, bag]`` (differentiable in
    ``table``)."""
    if weights is not None and weights.requires_grad:
        raise ValueError("embedding_bag: no gradient for the weights")
    lead, bag = idx.shape[:-1], idx.shape[-1]
    flat_w = None if weights is None else weights.reshape(-1, bag)
    out = EmbeddingBagFn.apply(table, idx.reshape(-1, bag), flat_w,
                               out_dtype)
    return out.reshape(*lead, table.shape[1])


def rows_sharded(cfg: RecsysConfig, mesh) -> bool:
    """Whether ``mesh`` shards the table by rows (``"model"`` divides
    ``v_total``, as ``recsys_param_shardings`` decides)."""
    return (mesh is not None and n_model(mesh) > 1
            and cfg.v_total % n_model(mesh) == 0)


def local_ids(gid: torch.Tensor, off: int, rows: int,
              v_total: int) -> torch.Tensor:
    """Global table rows -> rows of the shard ``[off, off + rows)``;
    ``-1``, and ids of the other shards, -> ``-1``.  An id past the table
    counts as its last row first, as one process clamps it."""
    gid = torch.where(gid >= 0, gid.clamp(max=v_total - 1), -1)
    here = (gid >= off) & (gid < off + rows)
    return torch.where(here, gid - off, -1)


def lookup(cfg: RecsysConfig, table: torch.Tensor, gid: torch.Tensor,
           mesh=None) -> torch.Tensor:
    """Bags of global rows ``[..., bag]`` -> ``[..., d]`` in the table's
    dtype, through the EmbeddingBag kernel; on a mesh that shards the
    rows, this rank's partial bags in f32 summed over ``"model"`` and
    rounded once (the gradient reaches the local rows only)."""
    if not rows_sharded(cfg, mesh):
        return embedding_bag(table, gid)
    rows = table.shape[0]
    part = embedding_bag(table, local_ids(gid, mesh.coord("model") * rows,
                                          rows, cfg.v_total),
                         out_dtype=torch.float32)
    return coll.reduce_from(part, mesh.group("model")).to(table.dtype)


def sparse_features(cfg: RecsysConfig, params: dict,
                    sparse_idx: torch.Tensor, mesh=None) -> torch.Tensor:
    """sparse_idx ``[B, n_sparse(, bag)]`` per-feature ids -> ``[B, F*d]``."""
    if sparse_idx.dim() == 2:
        sparse_idx = sparse_idx[..., None]
    off = table_offsets(cfg, sparse_idx.device)                 # [F]
    gid = torch.where(sparse_idx >= 0, sparse_idx + off[None, :, None], -1)
    emb = lookup(cfg, params["table"], gid, mesh)               # [B, F, d]
    return emb.reshape(emb.shape[0], -1)


def _tower(cfg: RecsysConfig, params: dict, dense: torch.Tensor,
           sparse_idx: torch.Tensor, mesh=None) -> torch.Tensor:
    """The DCN-v2 stack up to the top MLP output ``[B, mlp[-1]]``."""
    emb = sparse_features(cfg, params, sparse_idx, mesh)
    x0 = torch.cat([dense.to(emb.dtype), emb], dim=-1)
    x = x0
    for p in params["cross"]:
        x = x0 * (x @ p["W"] + p["b"]) + x
    for p in params["mlp"]:
        x = torch.relu(x @ p["W"] + p["b"])
    return x


def _logits(cfg: RecsysConfig, params: dict, batch: dict,
            compute_dtype, mesh=None) -> torch.Tensor:
    params = cast_for_compute(params, compute_dtype)
    x = _tower(cfg, params, batch["dense"], batch["sparse"], mesh)
    p = params["head"]
    return (x @ p["W"] + p["b"])[..., 0]


@torch.no_grad()
def forward(cfg: RecsysConfig, params: dict, batch: dict,
            compute_dtype=torch.bfloat16, mesh=None) -> torch.Tensor:
    """CTR logits ``[B]`` in the compute dtype (on a mesh, of this
    rank's rows)."""
    return _logits(cfg, params, batch, compute_dtype, mesh)


def train_loss(cfg: RecsysConfig, params: dict, batch: dict,
               compute_dtype=torch.bfloat16, mesh=None) -> torch.Tensor:
    """Mean logistic loss of the forward's logits (bf16 unless asked,
    as the reference trains) against ``label``, computed stably in
    f32.  On a mesh the mean is over the data ranks' rows together."""
    logits = _logits(cfg, params, batch, compute_dtype, mesh).float()
    y = batch["label"].float()
    loss = (torch.clamp(logits, min=0) - logits * y
            + torch.log1p(torch.exp(-logits.abs())))
    if mesh is None:
        return torch.mean(loss)
    data = mesh.group(data_axes(mesh))
    count = coll.all_reduce(loss.new_tensor(float(loss.numel())), data)
    return coll.reduce_from(loss.sum(), data) / count


@torch.no_grad()
def serve_retrieval(cfg: RecsysConfig, params: dict, batch: dict,
                    compute_dtype=torch.bfloat16, mesh=None) -> torch.Tensor:
    """One query against ``n_candidates`` item rows: scores
    ``[n_candidates]`` (f32).

    batch = {dense ``[1, n_dense]``, sparse ``[1, n_sparse]``, cand_ids
    ``[n_cand]``}, where cand_ids index the item feature's slice of the
    shared table.  On a mesh every rank scores every candidate, its
    rows looked up as bags of one id (``lookup``)."""
    params = cast_for_compute(params, compute_dtype)
    x = _tower(cfg, params, batch["dense"], batch["sparse"], mesh)
    u = x @ params["retrieval_proj"]                           # [1, d_emb]
    if rows_sharded(cfg, mesh):
        cand = lookup(cfg, params["table"], batch["cand_ids"][:, None],
                      mesh)
    else:
        cand = params["table"][batch["cand_ids"]]              # [C, d_emb]
    return (cand @ u[0]).float()

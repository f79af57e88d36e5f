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
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

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
    def forward(ctx, table, idx, weights):
        ctx.save_for_backward(idx, weights)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return _embedding_bag(table, idx, weights)

    @staticmethod
    def backward(ctx, grad_out):
        idx, weights = ctx.saved_tensors
        return embedding_bag_grad(grad_out, idx, weights, ctx.table_shape,
                                  ctx.table_dtype), None, None


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
    valid = idx >= 0
    acc = torch.zeros((V, d), dtype=torch.float32, device=grad_out.device)
    acc.index_add_(0, idx[valid].long().clamp(max=V - 1), g[valid])
    return acc.to(table_dtype)


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """idx ``[..., bag]`` (rows of ``table``; -1 = padding) -> the weighted
    sum over the bag ``[..., d]``, through the EmbeddingBag kernel on
    ``[N, bag]`` (differentiable in ``table``)."""
    if weights is not None and weights.requires_grad:
        raise ValueError("embedding_bag: no gradient for the weights")
    lead, bag = idx.shape[:-1], idx.shape[-1]
    flat_w = None if weights is None else weights.reshape(-1, bag)
    out = EmbeddingBagFn.apply(table, idx.reshape(-1, bag), flat_w)
    return out.reshape(*lead, table.shape[1])


def sparse_features(cfg: RecsysConfig, params: dict,
                    sparse_idx: torch.Tensor) -> torch.Tensor:
    """sparse_idx ``[B, n_sparse(, bag)]`` per-feature ids -> ``[B, F*d]``."""
    if sparse_idx.dim() == 2:
        sparse_idx = sparse_idx[..., None]
    off = table_offsets(cfg, sparse_idx.device)                 # [F]
    gid = torch.where(sparse_idx >= 0, sparse_idx + off[None, :, None], -1)
    emb = embedding_bag(params["table"], gid)                   # [B, F, d]
    return emb.reshape(emb.shape[0], -1)


def _tower(cfg: RecsysConfig, params: dict, dense: torch.Tensor,
           sparse_idx: torch.Tensor) -> torch.Tensor:
    """The DCN-v2 stack up to the top MLP output ``[B, mlp[-1]]``."""
    emb = sparse_features(cfg, params, sparse_idx)
    x0 = torch.cat([dense.to(emb.dtype), emb], dim=-1)
    x = x0
    for p in params["cross"]:
        x = x0 * (x @ p["W"] + p["b"]) + x
    for p in params["mlp"]:
        x = torch.relu(x @ p["W"] + p["b"])
    return x


def _logits(cfg: RecsysConfig, params: dict, batch: dict,
            compute_dtype) -> torch.Tensor:
    params = cast_for_compute(params, compute_dtype)
    x = _tower(cfg, params, batch["dense"], batch["sparse"])
    p = params["head"]
    return (x @ p["W"] + p["b"])[..., 0]


@torch.no_grad()
def forward(cfg: RecsysConfig, params: dict, batch: dict,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """CTR logits ``[B]`` in the compute dtype."""
    return _logits(cfg, params, batch, compute_dtype)


def train_loss(cfg: RecsysConfig, params: dict, batch: dict,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Mean logistic loss of the forward's logits (bf16 unless asked,
    as the reference trains) against ``label``, computed stably in
    f32."""
    logits = _logits(cfg, params, batch, compute_dtype).float()
    y = batch["label"].float()
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-logits.abs())))


@torch.no_grad()
def serve_retrieval(cfg: RecsysConfig, params: dict, batch: dict,
                    compute_dtype=torch.bfloat16) -> torch.Tensor:
    """One query against ``n_candidates`` item rows: scores
    ``[n_candidates]`` (f32).

    batch = {dense ``[1, n_dense]``, sparse ``[1, n_sparse]``, cand_ids
    ``[n_cand]``}, where cand_ids index the item feature's slice of the
    shared table."""
    params = cast_for_compute(params, compute_dtype)
    x = _tower(cfg, params, batch["dense"], batch["sparse"])   # [1, mlp-1]
    u = x @ params["retrieval_proj"]                           # [1, d_emb]
    cand = params["table"][batch["cand_ids"]]                  # [C, d_emb]
    return (cand @ u[0]).float()

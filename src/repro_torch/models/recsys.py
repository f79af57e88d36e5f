"""DCN-v2 (Wang et al., arXiv:2008.13535) serving: forward and retrieval.

The port of ``repro.models.recsys`` (the JAX package, which stays the
reference).  All sparse tables are concatenated into one ``table
[V_total, d_emb]`` with per-feature row offsets, so the lookup of a batch
is one EmbeddingBag call: on the card the hand-written kernel
(``kernels/embedding_bag``), on the CPU its plain version.

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
call is then a no-op, not a copy of the 2 GB table.  ``batch`` holds
torch tensors: ``dense [B, n_dense]``, ``sparse [B, n_sparse(, bag)]``
(per-feature ids, -1 = padding) and, for retrieval, ``cand_ids``.

Not ported yet: ``train_loss`` (training is later work).
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


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """idx ``[..., bag]`` (rows of ``table``; -1 = padding) -> the weighted
    sum over the bag ``[..., d]``, through the EmbeddingBag kernel on
    ``[N, bag]``."""
    lead, bag = idx.shape[:-1], idx.shape[-1]
    flat_w = None if weights is None else weights.reshape(-1, bag)
    out = _embedding_bag(table, idx.reshape(-1, bag), flat_w)
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


@torch.no_grad()
def forward(cfg: RecsysConfig, params: dict, batch: dict,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """CTR logits ``[B]`` in the compute dtype."""
    params = cast_for_compute(params, compute_dtype)
    x = _tower(cfg, params, batch["dense"], batch["sparse"])
    p = params["head"]
    return (x @ p["W"] + p["b"])[..., 0]


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

"""Edge-parallel GNN message passing on a model mesh (the port of
``repro.dist.gnn_sharded``).

Every rank owns a contiguous slice of the edge set over the data axes
(``data_axes``: ``("data",)`` or ``("pod", "data")``), runs the model's
own ``forward`` on its local edges with ``cfg.shard_axes`` set, so each
``seg_sum`` / ``seg_max`` finishes with a psum / pmax over those axes
(``models.gnn.EdgeAxes``), and the loss equals ``gnn.train_loss`` on the
full batch.  The ``model`` ranks repeat their data coordinate's edge
work, as in the reference.

Partitioning contract (``_batch_specs``, as the reference's):

* non-GraphCast: node arrays (feats / labels / mask) replicated, edge
  arrays (``senders`` / ``receivers``, global node ids) sharded over the
  data axes;
* GraphCast ``grid_sharded``: the grid-node arrays and the grid-incident
  edge arrays sharded together (grid ids LOCAL to the shard), the mesh
  nodes and mesh-mesh edges replicated, so g2m aggregations psum across
  shards while the processor and the m2g decode stay local.

``local_batch`` cuts a full batch (global ids) into a rank's piece under
that contract; the reference leaves the cut to its caller.

**Gradients.**  The parameters are replicated.  Every rank holds the
whole loss, so the loss hands each rank ``1 / n_data`` of its gradient
(``collectives.divide_grad``, the reference's closing ``pmean``), and a
psum's backward is a psum: each rank's gradient is its share of the
repeated node-level work plus its own edges' part, and
``train.steps.make_train_step``'s sum over the data axes (the
replicated-input transpose of ``shard_map``) adds them up to the full
gradient, counting each repeated computation once.  The model ranks hold
equal gradients, which the step does not sum.  Under remat
(``torch.utils.checkpoint``) the recomputed forward runs its all-reduces
again in backward, in the same order on every rank.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from ..models import gnn
from . import collectives as coll
from .sharding import P, data_axes, n_data

_GRID_KEYS = ("feats", "target", "grid_mask", "g2m_senders",
              "g2m_receivers", "m2g_senders", "m2g_receivers")


def _batch_specs(cfg, batch, da) -> dict:
    """PartitionSpec per batch entry (prefix tree matching the batch)."""
    edge = P(da)
    if cfg.kind == "graphcast":
        return {k: (edge if k in _GRID_KEYS else P()) for k in batch}
    specs = {k: P() for k in batch}
    for k in ("senders", "receivers"):
        if k in batch:
            specs[k] = edge
    return specs


def make_sharded_gnn_loss(cfg, mesh, batch=None):
    """``loss(params, local) -> scalar`` equal to ``gnn.train_loss`` on
    the full batch, ``local`` this rank's piece of it (``local_batch``).
    ``batch`` is the reference's argument, which its ``shard_map`` needs
    for the specs; the port does not read it."""
    da = data_axes(mesh)
    cfg_sh = replace(cfg, shard_axes=da,
                     grid_sharded=(cfg.kind == "graphcast"))
    group, n = mesh.group(da), n_data(mesh)

    def loss(params, b):
        if cfg.kind == "graphcast":
            out = gnn.forward(cfg_sh, params, b, mesh=mesh)
            mask = b.get("grid_mask")
            if mask is None:
                mask = out.new_ones((out.shape[0],))
            se = torch.sum((out - b["target"]) ** 2 * mask[:, None])
            cnt = torch.sum(mask.detach()) * out.shape[1]
            se = coll.psum(se, group)
            cnt = coll.all_reduce(cnt, group)
            value = se / torch.clamp(cnt, min=1.0)
        else:
            value = gnn.train_loss(cfg_sh, params, b, mesh=mesh)
        # identical on every rank: each takes 1/n of its gradient
        return coll.divide_grad(value, n)

    return loss


def local_batch(cfg, batch: dict, mesh) -> dict:
    """This rank's piece of a full batch (numpy arrays or tensors, node
    and grid ids global) under ``_batch_specs``.

    * edge arrays: contiguous slice ``r`` of ``n_data`` over the data
      axes (``r = mesh.coord(data_axes)``);
    * GraphCast: grid rows ``[r ng/D, (r+1) ng/D)`` of ``feats`` /
      ``target`` / ``grid_mask``, and the g2m and m2g edges whose grid
      end lies in them, in their order, that end made local.  A g2m
      sender outside the grid counts as the row the gather clamps it to;
      an m2g edge whose grid receiver is outside the grid (a pad, which
      the sum drops) goes to no rank;
    * everything else whole.
    """
    da = data_axes(mesh)
    n, r = n_data(mesh), mesh.coord(da)
    specs = _batch_specs(cfg, batch, da)
    if cfg.kind != "graphcast":
        out = dict(batch)
        for k, v in batch.items():
            if specs[k].dims:
                if len(v) % n:
                    raise ValueError(f"{k}: {len(v)} edges do not divide "
                                     f"over {n} data ranks")
                size = len(v) // n
                out[k] = v[r * size:(r + 1) * size]
        return out
    ng = batch["feats"].shape[0]
    if ng % n:
        raise ValueError(f"{ng} grid rows do not divide over {n} data ranks")
    nl = ng // n
    lo = r * nl
    out = {k: v for k, v in batch.items() if k not in _GRID_KEYS}
    for k in ("feats", "target", "grid_mask"):
        if k in batch:
            out[k] = batch[k][lo:lo + nl]
    snd = batch["g2m_senders"].clip(0, ng - 1)
    keep = (snd >= lo) & (snd < lo + nl)
    out["g2m_senders"] = (snd - lo)[keep]
    out["g2m_receivers"] = batch["g2m_receivers"][keep]
    rcv = batch["m2g_receivers"]
    keep = (rcv >= lo) & (rcv < lo + nl)
    out["m2g_senders"] = batch["m2g_senders"][keep]
    out["m2g_receivers"] = (rcv - lo)[keep]
    return out

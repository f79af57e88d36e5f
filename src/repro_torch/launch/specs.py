"""Per-cell step functions, abstract inputs and placements (the dry-run
grid): the port of ``repro.launch.specs``.

``build_cell(arch, shape_name, mesh)`` returns a ``Cell`` bundling:

* ``fn``             -- one rank's step of ``mesh`` (a
                        ``launch.mesh.ModelMesh``: joined ranks, or a
                        ``layout_mesh`` for shapes alone): the port's
                        ``make_train_step`` or serve function;
* ``args``           -- meta tensors of the **global** shapes and dtypes
                        (the counterpart of the reference's
                        ``ShapeDtypeStruct``), no storage;
* ``in_shardings`` / ``out_shardings`` -- trees of the port's
                        ``PartitionSpec`` (``dist.sharding``), the
                        reference's placements;
* ``donate_argnums`` -- state-carrying args (params / opt / cache);
* ``model_flops``    -- the "useful work" term of the roofline (6·N·D
                        dense / 6·N_active·D MoE, family analogues for
                        GNN / recsys, documented per family below).

``fn`` takes each argument's piece on this rank (``dist.sharding.shard``
under ``in_shardings``; a sharded GNN cell's batch is cut by
``dist.gnn_sharded.local_batch``), except where ``runs_whole`` is set:
the GNN cells the reference leaves to GSPMD's partitioner, which torch
has no counterpart of, run whole on every rank, their ``args`` whole.
``Cell`` has no ``jit`` / ``lower``: torch compiles nothing ahead, and
``launch.dryrun`` runs ``fn`` on meta tensors instead.  ``port_notes``
says where the port's step differs from the reference's in what it
computes for a cell (``notes`` are the reference's, word for word).

All shapes are the assignment's exact numbers; edge counts are padded up
to a multiple of 512 (one pad edge pointing at a trash node) so edge
arrays shard evenly on any production mesh -- padding is recorded in
``Cell.notes``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial
from typing import Any, Callable

import torch

from ..configs import get_config, get_skips, shapes_for
from ..dist import sharding as shd
from ..dist.sharding import P
from ..models import gnn, recsys, transformer
from ..models.convert import abstract_recsys
from ..train.optimizer import AdamWConfig, adamw_init
from ..train.steps import make_train_step

F32, BF16, I32 = torch.float32, torch.bfloat16, torch.int32

# ---------------------------------------------------------------------------
# Per-cell performance configuration (the reference's hill-climbed
# overrides, copied):
#   accum       -- microbatch gradient-accumulation steps (memory / accum)
#   sp          -- Megatron-style sequence-parallel residual stream
#   zero        -- ZeRO: shard Adam moments over the data axes
#   sharded_gnn -- edge-parallel message passing (dist/gnn_sharded.py)
#   remat_group -- GNN grouped remat (checkpoint every k layers)
# ---------------------------------------------------------------------------
PERF: dict = {
    ("granite-8b", "train_4k"): dict(accum=8, sp=True, zero=True),
    ("gemma2-27b", "train_4k"): dict(accum=8, sp=True, zero=True),
    ("deepseek-7b", "train_4k"): dict(accum=8, sp=True, zero=True),
    ("qwen2-moe-a2.7b", "train_4k"): dict(accum=4, sp=True, zero=True),
    ("granite-moe-3b-a800m", "train_4k"): dict(accum=4, sp=True, zero=True),
    ("gat-cora", "ogb_products"): dict(sharded_gnn=True),
    ("gat-cora", "minibatch_lg"): dict(sharded_gnn=True),
    ("gatedgcn", "ogb_products"): dict(sharded_gnn=True, remat_group=4),
    ("gatedgcn", "minibatch_lg"): dict(sharded_gnn=True, remat_group=4),
    ("graphsage-reddit", "ogb_products"): dict(sharded_gnn=True),
    ("graphcast", "ogb_products"): dict(sharded_gnn=True, remat_group=4),
    ("graphcast", "minibatch_lg"): dict(sharded_gnn=True, remat_group=4),
}


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype``: no storage."""
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device="meta")


def _pad512(e: int) -> int:
    return -(-e // 512) * 512


def _whole(batch):
    """A batch that already is this rank's piece."""
    return batch


@dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    fn: Callable
    args: tuple
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple
    model_flops: float
    notes: str = ""
    cfg: Any = None              # the model config as the cell runs it
    runs_whole: bool = False     # fn takes the args whole on every rank
    port_notes: str = ""
    d_in: int = 0                # a GNN cell's input and output widths
    d_out: int = 0


def _opt_cfg() -> AdamWConfig:
    return AdamWConfig()


def _moe_note(cfg, mesh) -> list:
    if cfg.is_moe and shd.n_data(mesh) > 1:
        return ["on meta tensors the MoE slot table is the capacity wide "
                "(the reference's static width; real runs size it to the "
                "rank's fullest expert)"]
    return []


def _heads_note(cfg, mesh) -> list:
    if cfg.n_heads % shd.n_model(mesh):
        return [f"{cfg.n_heads} query heads over {shd.n_model(mesh)} model "
                "ranks: the attention block runs whole on every model rank"]
    return []


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------
def _lm_train_cell(arch, cfg, shape_name, sh, mesh) -> Cell:
    B, S = sh["global_batch"], sh["seq_len"]
    pf = PERF.get((arch, shape_name), {})
    notes = []
    if pf.get("sp"):
        da = shd.data_axes(mesh)
        if S % shd.n_model(mesh) == 0:
            cfg = replace(cfg, residual_spec=(da, "model", None))
            notes.append("SP residuals (seq over model)")
    params = transformer.abstract_params(cfg)
    opt = adamw_init(params)
    batch = dict(tokens=sds((B, S), I32), labels=sds((B, S), I32),
                 mask=sds((B, S), F32))
    p_sh = shd.lm_param_shardings(cfg, params, mesh)
    o_sh = shd.opt_state_shardings(p_sh, mesh, params=params,
                                   zero=pf.get("zero", False))
    b_sh = shd.lm_batch_shardings(mesh)
    accum = pf.get("accum", 1)
    if accum > 1:
        notes.append(f"grad accumulation x{accum}")
    step = make_train_step(partial(transformer.train_loss, cfg, mesh=mesh),
                           _opt_cfg(), accum_steps=accum, mesh=mesh,
                           param_specs=p_sh, state_specs=o_sh, share=_whole)
    flops = 6.0 * cfg.active_param_count() * B * S
    return Cell(arch=arch, shape=shape_name, kind="train", fn=step,
                args=(params, opt, batch),
                in_shardings=(p_sh, o_sh, b_sh),
                out_shardings=(p_sh, o_sh, None),
                donate_argnums=(0, 1), model_flops=flops,
                notes="; ".join(notes), cfg=cfg,
                port_notes="; ".join(_heads_note(cfg, mesh)
                                     + _moe_note(cfg, mesh)))


def _lm_prefill_cell(arch, cfg, shape_name, sh, mesh) -> Cell:
    B, S = sh["global_batch"], sh["seq_len"]
    params = transformer.abstract_params(cfg)
    p_sh = shd.lm_param_shardings(cfg, params, mesh)
    da = shd.data_axes(mesh)
    tok = sds((B, S), I32)
    kv_on_model = cfg.n_kv_heads % shd.n_model(mesh) == 0
    kv = P(None, da, None, "model" if kv_on_model else None, None)
    cache_sh = dict(k=kv, v=kv, kv_len=P())

    def serve_step(params, tokens):
        return transformer.prefill(cfg, params, tokens, cache_len=S,
                                   mesh=mesh)

    return Cell(arch=arch, shape=shape_name, kind="prefill", fn=serve_step,
                args=(params, tok),
                in_shardings=(p_sh, P(da, None)),
                out_shardings=(None, cache_sh), donate_argnums=(),
                model_flops=2.0 * cfg.active_param_count() * B * S, cfg=cfg,
                port_notes="; ".join(_heads_note(cfg, mesh)
                                     + _moe_note(cfg, mesh)))


def _lm_decode_cell(arch, cfg, shape_name, sh, mesh) -> Cell:
    B, S = sh["global_batch"], sh["seq_len"]
    params = transformer.abstract_params(cfg)
    p_sh = shd.lm_param_shardings(cfg, params, mesh)
    da = shd.data_axes(mesh)
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    cache = dict(k=sds((L, B, S, Hkv, hd), BF16),
                 v=sds((L, B, S, Hkv, hd), BF16),
                 kv_len=sds((), I32))
    # Flash-decoding layout: the cache SEQUENCE dim shards over "model";
    # QK/PV contract locally per S-shard and only the softmax stats and
    # the [B, 1, Hq, hd] output psum across "model".  When the batch can't
    # cover the data axes (long_500k B=1), S shards over (data x model).
    seq_sharded = B < shd.n_data(mesh)
    if seq_sharded:
        seq_axes = (*da, "model")
        kv = P(None, None, seq_axes, None, None)
        notes = "SP decode: KV sequence sharded over (data x model)"
    else:
        seq_axes = ("model",)
        kv = P(None, da, "model", None, None)
        notes = "flash-decoding: KV sequence sharded over model"
    cache_sh = dict(k=kv, v=kv, kv_len=P())
    tok = sds((B, 1), I32)

    def serve_step(params, cache, tokens):
        return transformer.decode_step(cfg, params, cache, tokens,
                                       mesh=mesh, seq_axes=seq_axes)

    return Cell(arch=arch, shape=shape_name, kind="decode", fn=serve_step,
                args=(params, cache, tok),
                in_shardings=(p_sh, cache_sh,
                              P(da if B >= shd.n_data(mesh) else None,
                                None)),
                out_shardings=(None, cache_sh), donate_argnums=(1,),
                model_flops=2.0 * cfg.active_param_count() * B,
                notes=notes, cfg=cfg,
                port_notes="; ".join(
                    ["on meta tensors kv_len has no value: the step is "
                     "taken at a full cache (position S - 1)"]
                    + _heads_note(cfg, mesh)
                    + (_moe_note(cfg, mesh) if not seq_sharded else [])))


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------
def _gnn_flops(cfg, n, e, d_in, d_out) -> float:
    """Forward matmul FLOPs (family formulas; x3 for train)."""
    d, L = cfg.d_hidden, cfg.n_layers
    if cfg.kind == "gat":
        f = 2 * n * d_in * cfg.n_heads * d + 6 * e * cfg.n_heads * d
        f += (L - 1) * (2 * n * (cfg.n_heads * d) * cfg.n_heads * d
                        + 6 * e * cfg.n_heads * d)
        return float(f)
    if cfg.kind == "gatedgcn":
        per = 6 * n * d * d + 2 * e * d * d + 6 * e * d
        return float(2 * n * d_in * d + L * per + 2 * n * d * d_out)
    if cfg.kind == "sage":
        dims = [d_in] + [d] * (L - 1) + [d_out]
        return float(sum(4 * n * a * b + e * a
                         for a, b in zip(dims[:-1], dims[1:])))
    if cfg.kind == "graphcast":
        nm, em = max(16, n // cfg.mesh_ratio), 8 * max(16, n // cfg.mesh_ratio)
        enc = 8 * (2 * n) * d * d + 6 * nm * d * d
        proc = L * (8 * em * d * d + 6 * nm * d * d)
        dec = 8 * (2 * n) * d * d + 6 * n * d * d
        return float(4 * n * d_in * d + enc + proc + dec + 6 * n * d * d_out)
    raise ValueError(cfg.kind)


def _graphcast_edges(n: int, nm: int) -> dict:
    """GraphCast's mesh features and edge sets over ``n`` grid nodes and
    ``nm`` mesh nodes: every grid node twice in g2m and m2g, eight mesh
    edges a mesh node, each padded to a multiple of 512."""
    return dict(g2m_senders=sds((_pad512(2 * n),), I32),
                g2m_receivers=sds((_pad512(2 * n),), I32),
                mesh_senders=sds((_pad512(8 * nm),), I32),
                mesh_receivers=sds((_pad512(8 * nm),), I32),
                m2g_senders=sds((_pad512(2 * n),), I32),
                m2g_receivers=sds((_pad512(2 * n),), I32))


def _gnn_full_graph_batch(cfg, n, e, d_feat, n_classes):
    e_pad = _pad512(e)
    batch = dict(feats=sds((n, d_feat), F32),
                 senders=sds((e_pad,), I32), receivers=sds((e_pad,), I32))
    if cfg.kind == "graphcast":
        nm = max(16, n // cfg.mesh_ratio)
        batch.update(mesh_feats=sds((nm, d_feat), F32),
                     **_graphcast_edges(n, nm),
                     target=sds((n, cfg.n_vars), F32))
        # the plain senders/receivers arrays are unused by graphcast
        batch.pop("senders")
        batch.pop("receivers")
    else:
        batch.update(labels=sds((n,), I32), train_mask=sds((n,), F32))
    return batch


def _gnn_cell(arch, cfg, shape_name, sh, mesh) -> Cell:
    d_feat = sh["d_feat"]
    n_classes = sh["n_classes"]
    d_out = cfg.n_vars if cfg.kind == "graphcast" else n_classes
    notes = ""
    if shape_name == "minibatch_lg":
        cfg = replace(cfg, sample_sizes=tuple(sh["fanout"]))
        f1, f2 = cfg.sample_sizes
        n_seed = sh["batch_nodes"]
        n1 = n_seed + n_seed * f1
        n_table = n1 + n1 * f2
        batch = dict(
            feats=sds((n_table, d_feat), F32),
            blocks=[dict(senders=sds((n1 * f2,), I32),
                         receivers=sds((n1 * f2,), I32)),
                    dict(senders=sds((n_seed * f1,), I32),
                         receivers=sds((n_seed * f1,), I32))],
            labels=sds((n_seed,), I32))
        n_eff, e_eff = n_table, n1 * f2 + n_seed * f1
        notes = (f"sampled blocks: table={n_table} nodes (seed {n_seed}, "
                 f"fanout {f1}-{f2}) of n={sh['n_nodes']}, m={sh['n_edges']}")
        if cfg.kind != "sage":
            # non-SAGE archs consume the sampled subgraph as one padded graph
            e_pad = _pad512(e_eff)
            batch = dict(feats=sds((n_table, d_feat), F32),
                         senders=sds((e_pad,), I32),
                         receivers=sds((e_pad,), I32))
            if cfg.kind == "graphcast":
                nm = max(16, n_table // cfg.mesh_ratio)
                batch.update(mesh_feats=sds((nm, d_feat), F32),
                             **_graphcast_edges(n_table, nm),
                             target=sds((n_table, cfg.n_vars), F32))
            else:
                batch.update(labels=sds((n_table,), I32),
                             train_mask=sds((n_table,), F32))
            notes += "; consumed as one padded sampled subgraph (non-SAGE)"
    elif shape_name == "molecule":
        B, n, e = sh["batch"], sh["n_nodes"], sh["n_edges"]
        batch = dict(feats_batched=sds((B, n, d_feat), F32),
                     senders_b=sds((B, e), I32), receivers_b=sds((B, e), I32),
                     graph_label=sds((B, n_classes), F32))
        if cfg.kind == "graphcast":
            nm = max(4, n // 4)
            batch.update(mesh_feats=sds((nm, d_feat), F32),
                         g2m_senders=sds((n,), I32),
                         g2m_receivers=sds((n,), I32),
                         mesh_senders=sds((4 * nm,), I32),
                         mesh_receivers=sds((4 * nm,), I32),
                         m2g_senders=sds((n,), I32),
                         m2g_receivers=sds((n,), I32))
        n_eff, e_eff = B * n, B * e
    else:
        n_eff, e_eff = sh["n_nodes"], sh["n_edges"]
        batch = _gnn_full_graph_batch(cfg, n_eff, e_eff, d_feat, n_classes)
        if sh["n_edges"] != _pad512(sh["n_edges"]):
            notes = f"edges padded {sh['n_edges']} -> {_pad512(sh['n_edges'])}"

    if shape_name == "molecule" and cfg.kind == "graphcast":
        d_out = n_classes  # graph-level regression target width
    pf = PERF.get((arch, shape_name), {})
    if pf.get("remat_group"):
        cfg = replace(cfg, remat_group=pf["remat_group"])
    params = gnn.map_shapes(lambda _, shape: sds(shape, F32),
                            gnn.param_shapes(cfg, d_feat, d_out))
    opt = adamw_init(params)
    p_sh = shd.gnn_param_shardings(params, mesh)
    o_sh = shd.opt_state_shardings(p_sh, mesh)
    port_notes = ""
    if pf.get("sharded_gnn"):
        # edge-parallel message passing (see dist/gnn_sharded.py)
        from ..dist.gnn_sharded import _batch_specs, make_sharded_gnn_loss
        if cfg.kind == "graphcast":
            n_grid = batch["feats"].shape[0]
            n_grid_pad = _pad512(n_grid)
            if n_grid_pad != n_grid:
                for k in ("feats", "target"):
                    batch[k] = sds((n_grid_pad,) + tuple(batch[k].shape[1:]),
                                   F32)
                for k in ("g2m_senders", "g2m_receivers", "m2g_senders",
                          "m2g_receivers"):
                    batch[k] = sds((_pad512(2 * n_grid_pad),), I32)
                notes += f"; grid padded {n_grid} -> {n_grid_pad}"
            batch["grid_mask"] = sds((batch["feats"].shape[0],), F32)
        loss_fn = make_sharded_gnn_loss(cfg, mesh, batch)
        b_sh = _batch_specs(cfg, batch, shd.data_axes(mesh))
        step = make_train_step(loss_fn, _opt_cfg(), mesh=mesh,
                               param_specs=p_sh, state_specs=o_sh,
                               share=_whole)
        notes += "; shard_map edge-parallel message passing"
    else:
        b_sh = shd.gnn_batch_shardings(mesh, batch)
        step = make_train_step(partial(gnn.train_loss, cfg), _opt_cfg())
        port_notes = ("no GSPMD partitioner: the step runs whole on every "
                      "rank")
    flops = 3.0 * _gnn_flops(cfg, n_eff, e_eff, d_feat, d_out)
    return Cell(arch=arch, shape=shape_name, kind="train", fn=step,
                args=(params, opt, batch),
                in_shardings=(p_sh, o_sh, b_sh),
                out_shardings=(p_sh, o_sh, None),
                donate_argnums=(0, 1), model_flops=flops, notes=notes,
                cfg=cfg, runs_whole=not pf.get("sharded_gnn"),
                port_notes=port_notes, d_in=d_feat, d_out=d_out)


# ---------------------------------------------------------------------------
# recsys cells
# ---------------------------------------------------------------------------
def _recsys_flops(cfg, B: int) -> float:
    D = cfg.d_interact
    cross = cfg.n_cross_layers * 2 * D * D
    dims = (D,) + cfg.mlp
    mlp = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    return float(B * (cross + mlp))


def _recsys_cell(arch, cfg, shape_name, sh, mesh) -> Cell:
    params = abstract_recsys(cfg)
    p_sh = shd.recsys_param_shardings(params, mesh)
    if sh["kind"] == "train":
        B = sh["batch"]
        batch = dict(dense=sds((B, cfg.n_dense), F32),
                     sparse=sds((B, cfg.n_sparse), I32),
                     label=sds((B,), F32))
        opt = adamw_init(params)
        o_sh = shd.opt_state_shardings(p_sh, mesh)
        b_sh = shd.recsys_batch_shardings(mesh, batch)
        step = make_train_step(partial(recsys.train_loss, cfg, mesh=mesh),
                               _opt_cfg(), mesh=mesh, param_specs=p_sh,
                               state_specs=o_sh, share=_whole)
        return Cell(arch=arch, shape=shape_name, kind="train", fn=step,
                    args=(params, opt, batch),
                    in_shardings=(p_sh, o_sh, b_sh),
                    out_shardings=(p_sh, o_sh, None), donate_argnums=(0, 1),
                    model_flops=3.0 * _recsys_flops(cfg, B), cfg=cfg)
    if sh["kind"] == "serve":
        B = sh["batch"]
        batch = dict(dense=sds((B, cfg.n_dense), F32),
                     sparse=sds((B, cfg.n_sparse), I32))
        b_sh = shd.recsys_batch_shardings(mesh, batch)

        def serve_step(params, batch):
            return recsys.forward(cfg, params, batch, mesh=mesh)

        return Cell(arch=arch, shape=shape_name, kind="serve", fn=serve_step,
                    args=(params, batch), in_shardings=(p_sh, b_sh),
                    out_shardings=None, donate_argnums=(),
                    model_flops=_recsys_flops(cfg, B), cfg=cfg)
    # retrieval
    C = sh["n_candidates"]
    batch = dict(dense=sds((1, cfg.n_dense), F32),
                 sparse=sds((1, cfg.n_sparse), I32),
                 cand_ids=sds((C,), I32))
    b_sh = shd.recsys_batch_shardings(mesh, batch)

    def serve_step(params, batch):
        return recsys.serve_retrieval(cfg, params, batch, mesh=mesh)

    return Cell(arch=arch, shape=shape_name, kind="retrieval", fn=serve_step,
                args=(params, batch), in_shardings=(p_sh, b_sh),
                out_shardings=None, donate_argnums=(),
                model_flops=_recsys_flops(cfg, 1) + 2.0 * C * cfg.embed_dim,
                cfg=cfg)


# ---------------------------------------------------------------------------
def build_cell(arch: str, shape_name: str, mesh) -> Cell:
    cfg = get_config(arch)
    sh = shapes_for(arch)[shape_name]
    skip = get_skips(arch).get(shape_name)
    if skip:
        raise ValueError(f"{arch} x {shape_name} is skipped: {skip}")
    if cfg.family == "lm":
        if sh["kind"] == "train":
            return _lm_train_cell(arch, cfg, shape_name, sh, mesh)
        if sh["kind"] == "prefill":
            return _lm_prefill_cell(arch, cfg, shape_name, sh, mesh)
        return _lm_decode_cell(arch, cfg, shape_name, sh, mesh)
    if cfg.family == "gnn":
        return _gnn_cell(arch, cfg, shape_name, sh, mesh)
    if cfg.family == "recsys":
        return _recsys_cell(arch, cfg, shape_name, sh, mesh)
    raise ValueError(cfg.family)

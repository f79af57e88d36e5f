"""GNN zoo: GAT, GatedGCN, GraphSAGE, GraphCast as segment-op message
passing (the port of ``repro.models.gnn``, whose docstring holds the
design notes).

Plain functions on dict parameters (the reference's pytree as torch
tensors: ``convert.tree_from_numpy`` / ``convert.init_gnn``), so
parameter paths and checkpoints match the reference's.  Message passing
is gather -> per-edge function -> scatter over receivers; the scatters
are torch ops (``index_add_``, ``scatter_reduce_``), as the reference
leaves them to XLA: no Pallas kernel sits on this path.

Graph batches are static-shape dicts of tensors:

  full graph:  senders [E], receivers [E], feats [N, F], labels [N],
               train_mask [N]
  minibatch:   the block format of ``graphs/neighbor_sampler.py``
  molecule:    feats_batched [B, n, F], senders_b / receivers_b [B, E],
               graph_label [B, C]

**Pad edges.**  A pad edge's receiver is ``n`` (out of range).  jax's
segment ops drop it silently; torch's scatters raise on it, so every
scatter here writes ``n + 1`` rows (any receiver outside ``[0, n)`` to
the last) and slices that trash row off.  A segment with no edges has
max ``-inf``, as in jax; pad edges read node ``n - 1`` where the
reference does.

The molecule path runs the ``B`` graphs as one batched graph (node ids
offset by ``b * n``, pad receivers to the batch's trash row) and averages
per graph, where the reference maps ``forward`` over the graphs with
``jax.vmap``; a pad edge then reads node ``B * n - 1`` rather than its
graph's last node, which reaches no output.

Remat (``cfg.remat``, every ``remat_group`` layers) is
``torch.utils.checkpoint``.

**Edge-parallel message passing** (the reference's ``shard_map``
``axes``, ``cfg.shard_axes`` / ``cfg.grid_sharded``): ``forward`` and
``train_loss`` take ``mesh=`` (one rank of a ``launch.mesh.ModelMesh``)
and every layer an ``EdgeAxes``, bound to the mesh's group over
``cfg.shard_axes``.  Each rank aggregates its own slice of the edges and
``EdgeAxes.sum`` / ``.max`` combine the partial node aggregates over
the group (``dist.collectives.psum`` / ``pmax``, the reference's psum /
pmax); ``LOCAL`` (no mesh) makes them identities, so one layer code
serves both.  ``dist.gnn_sharded`` builds the sharded loss.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..dist import collectives as coll
from .layers import cast_for_compute, dense_init, layer_norm, softmax_xent


@dataclass(frozen=True)
class GNNConfig:
    """A copy of ``repro.models.gnn.GNNConfig`` (same fields and
    defaults)."""
    name: str
    kind: str                   # gat | gatedgcn | sage | graphcast
    n_layers: int
    d_hidden: int
    n_heads: int = 1
    aggregator: str = "sum"     # sum | mean | max | attn | gated
    sample_sizes: tuple = ()    # GraphSAGE fanouts
    mesh_refinement: int = 0    # GraphCast
    n_vars: int = 0             # GraphCast output channels
    mesh_ratio: int = 25        # GraphCast: grid nodes per mesh node
    remat: bool = True
    remat_group: int = 1        # checkpoint every k layers (sqrt-remat)
    shard_axes: tuple = ()      # shard_map axes the edge set is sharded over
    grid_sharded: bool = False  # GraphCast: grid nodes sharded over axes
    family: str = "gnn"


class EdgeAxes:
    """The mesh axes a rank's edge slice is sharded over: ``sum`` and
    ``max`` combine partial node aggregates over them (all-reduce; the
    sum's backward all-reduces too, as shard_map transposes a psum).
    Without axes every reduction is the identity (``LOCAL``)."""

    def __init__(self, mesh=None, axes=()):
        self.axes = tuple(axes)
        self.group = None
        if self.axes:
            if mesh is None:
                raise ValueError(f"edge axes {self.axes} need mesh=")
            self.group = mesh.group(self.axes)

    def sum(self, x):
        return coll.psum(x, self.group)

    def max(self, x):
        return coll.pmax(x, self.group)


LOCAL = EdgeAxes()


# ---------------------------------------------------------------------------
# segment-op primitives
# ---------------------------------------------------------------------------
def _trash(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Segment ids as int64, any id outside ``[0, n)`` sent to row ``n``."""
    idx = idx.long()
    return torch.where((idx >= 0) & (idx < n), idx, n)


def _safe(receivers, n):
    """Receivers clamped to ``n - 1``: where a pad edge reads node state."""
    return torch.clamp(receivers.long(), max=n - 1)


def seg_sum(x, idx, n, axes=LOCAL):
    out = x.new_zeros((n + 1,) + tuple(x.shape[1:]))
    return axes.sum(out.index_add(0, _trash(idx, n), x)[:n])


def seg_mean(x, idx, n, axes=LOCAL):
    s = seg_sum(x, idx, n, axes)
    cnt = seg_sum(x.new_ones((x.shape[0], 1)), idx, n, axes)
    return s / torch.clamp(cnt, min=1)


def seg_max(x, idx, n, axes=LOCAL):
    """Per-segment max; ``-inf`` for an empty segment.  Not
    differentiated (the softmax's max carries no gradient)."""
    out = x.new_full((n + 1,) + tuple(x.shape[1:]), float("-inf"))
    index = _trash(idx, n).reshape((-1,) + (1,) * (x.dim() - 1))
    out.scatter_reduce_(0, index.expand_as(x), x, reduce="amax",
                        include_self=True)
    return axes.max(out[:n])


def edge_softmax(logits, receivers, n, axes=LOCAL):
    """Per-receiving-node softmax over incoming edges.  logits [E, H]."""
    mx = seg_max(logits.detach(), receivers, n, axes)
    safe = _safe(receivers, n)
    ex = torch.exp(logits - mx[safe])
    den = seg_sum(ex, receivers, n, axes)
    return ex / torch.clamp(den[safe], min=1e-16)


# ---------------------------------------------------------------------------
# GAT (Velickovic et al., arXiv:1710.10903)
# ---------------------------------------------------------------------------
def _gat_layer(p, h, senders, receivers, n, heads, d_out, concat,
               axes=LOCAL):
    z = (h @ p["W"]).reshape(-1, heads, d_out)             # [N, H, D]
    al = torch.einsum("nhd,hd->nh", z, p["a_src"])          # [N, H]
    ar = torch.einsum("nhd,hd->nh", z, p["a_dst"])
    e = F.leaky_relu(al[senders] + ar[_safe(receivers, n)], 0.2)
    att = edge_softmax(e, receivers, n, axes)               # [E, H]
    msg = z[senders] * att[..., None]
    out = seg_sum(msg.reshape(-1, heads * d_out), receivers, n, axes)
    if not concat:
        out = out.reshape(-1, heads, d_out).mean(dim=1)
    return out


# ---------------------------------------------------------------------------
# GatedGCN (Dwivedi & Bresson benchmark, arXiv:2003.00982)
# ---------------------------------------------------------------------------
def _gatedgcn_layer(p, h, e, senders, receivers, n, axes=LOCAL):
    """Returns (h', e'): gated message passing with edge-feature state."""
    hs = h[senders]
    e_new = e @ p["E"] + hs @ p["A"] + h[_safe(receivers, n)] @ p["B"]
    eta = torch.sigmoid(e_new)                              # [E, d]
    msg = eta * (hs @ p["V"])
    den = seg_sum(eta, receivers, n, axes) + 1e-6
    agg = seg_sum(msg, receivers, n, axes) / den
    h_new = h @ p["U"] + agg
    h = h + F.relu(layer_norm(h_new, p["ln_h_s"], p["ln_h_b"]))
    e = e + F.relu(layer_norm(e_new, p["ln_e_s"], p["ln_e_b"]))
    return h, e


# ---------------------------------------------------------------------------
# GraphSAGE (Hamilton et al., arXiv:1706.02216), mean aggregator
# ---------------------------------------------------------------------------
def _sage_layer(p, h_dst, h_src, senders, receivers, n_dst, axes=LOCAL):
    """Bipartite-friendly: dst nodes aggregate from src-node neighbours."""
    agg = seg_mean(h_src[senders], receivers, n_dst, axes)
    return h_dst @ p["W_self"] + agg @ p["W_neigh"]


# ---------------------------------------------------------------------------
# GraphCast (Lam et al., arXiv:2212.12794): encoder-processor-decoder
# ---------------------------------------------------------------------------
def _mlp(ps, x):
    for i, p in enumerate(ps):
        x = x @ p["W"] + p["b"]
        if i < len(ps) - 1:
            x = F.silu(x)
    return x


def _interaction(p, h_src, h_dst, e, senders, receivers, n_dst,
                 axes=LOCAL):
    """Interaction-network block (GraphCast processor/enc/dec unit)."""
    e_in = torch.cat([e, h_src[senders], h_dst[_safe(receivers, n_dst)]],
                     dim=-1)
    e_new = e + _mlp(p["edge_mlp"], e_in)
    agg = seg_sum(e_new, receivers, n_dst, axes)
    h_new = h_dst + _mlp(p["node_mlp"], torch.cat([h_dst, agg], dim=-1))
    return h_new, e_new


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def _mlp_shapes(dims):
    return [dict(W=(a, b), b=(b,)) for a, b in zip(dims[:-1], dims[1:])]


def _interaction_shapes(d):
    return dict(edge_mlp=_mlp_shapes((3 * d, d, d)),
                node_mlp=_mlp_shapes((2 * d, d, d)))


def param_shapes(cfg: GNNConfig, d_in: int, d_out: int) -> dict:
    """The reference's ``init_params`` tree with a shape tuple per leaf."""
    d = cfg.d_hidden
    if cfg.kind == "gat":
        H = cfg.n_heads
        dims = [(d_in, d)] + [(H * d, d)] * (cfg.n_layers - 2) + [(H * d,
                                                                   d_out)]
        return dict(layers=[dict(W=(a, H * b), a_src=(H, b), a_dst=(H, b))
                            for a, b in dims])
    if cfg.kind == "gatedgcn":
        layer = {k: (d, d) for k in "UVABE"}
        layer.update(ln_h_s=(d,), ln_h_b=(d,), ln_e_s=(d,), ln_e_b=(d,))
        return dict(embed_h=(d_in, d), embed_e=(1, d),
                    layers=[dict(layer) for _ in range(cfg.n_layers)],
                    readout=(d, d_out))
    if cfg.kind == "sage":
        dims = [d_in] + [d] * (cfg.n_layers - 1) + [d_out]
        return dict(layers=[dict(W_self=(a, b), W_neigh=(a, b))
                            for a, b in zip(dims[:-1], dims[1:])])
    if cfg.kind == "graphcast":
        return dict(
            embed_grid=_mlp_shapes((d_in, d, d)),
            embed_mesh=_mlp_shapes((d_in, d, d)),
            embed_e_g2m=_mlp_shapes((1, d, d)),
            embed_e_mesh=_mlp_shapes((1, d, d)),
            embed_e_m2g=_mlp_shapes((1, d, d)),
            g2m=_interaction_shapes(d),
            processor=[_interaction_shapes(d) for _ in range(cfg.n_layers)],
            m2g=_interaction_shapes(d),
            readout=_mlp_shapes((d, d, d_out)))
    raise ValueError(cfg.kind)


def map_shapes(fn, tree, path=""):
    if isinstance(tree, dict):
        return {k: map_shapes(fn, v, f"{path}['{k}']")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_shapes(fn, v, f"{path}[{i}]")
                for i, v in enumerate(tree)]
    return fn(path, tree)


def init_params(cfg: GNNConfig, d_in: int, d_out: int,
                generator: torch.Generator, dtype=torch.float32,
                device=None) -> dict:
    """Weights as the reference's ``init_params`` draws them: matrices
    truncated-normal over ``sqrt(fan_in)`` (fan-in on axis 0, as
    ``dense_init``), biases and LayerNorm shifts zero, LayerNorm scales
    one; from ``generator`` on ``device``, leaf by leaf in tree order."""
    def draw(path, shape):
        if len(shape) == 2:
            return dense_init(shape, generator, dtype=dtype, device=device)
        fill = 1.0 if path.endswith(("'ln_h_s']", "'ln_e_s']")) else 0.0
        return torch.full(shape, fill, dtype=dtype, device=device)
    return map_shapes(draw, param_shapes(cfg, d_in, d_out))


# ---------------------------------------------------------------------------
# model-level forward
# ---------------------------------------------------------------------------
def _layer_groups(cfg, fn, state, layers):
    """Run ``state = fn(state, layer)`` over ``layers``, checkpointed per
    ``remat_group`` layers when ``cfg.remat``."""
    def group(ps, *st):
        for p in ps:
            st = fn(st, p)
        return st
    g = max(1, cfg.remat_group)
    for i in range(0, len(layers), g):
        ps = layers[i:i + g]
        if cfg.remat and torch.is_grad_enabled():
            state = checkpoint(group, ps, *state, use_reentrant=False)
        else:
            state = group(ps, *state)
    return state


def forward(cfg: GNNConfig, params: dict, batch: dict,
            compute_dtype=torch.float32, mesh=None) -> torch.Tensor:
    """Dispatch on cfg.kind and the batch's structure; node (or grid)
    outputs.  With ``cfg.shard_axes`` the batch holds this rank of
    ``mesh``'s edges (``dist.gnn_sharded``)."""
    ax = EdgeAxes(mesh, cfg.shard_axes)
    params = cast_for_compute(params, compute_dtype)
    if cfg.kind == "graphcast":
        return _forward_graphcast(cfg, params, batch, ax)
    if "blocks" in batch:
        return _forward_minibatch(cfg, params, batch)
    h = batch["feats"].to(compute_dtype)
    snd, rcv = batch["senders"].long(), batch["receivers"].long()
    n = h.shape[0]
    if cfg.kind == "gat":
        L = len(params["layers"])
        for i, p in enumerate(params["layers"]):
            last = i == L - 1
            h = _gat_layer(p, h, snd, rcv, n, cfg.n_heads,
                           p["a_src"].shape[1], concat=not last, axes=ax)
            if not last:
                h = F.elu(h)
        return h
    if cfg.kind == "gatedgcn":
        h = h @ params["embed_h"]
        e = h.new_ones((snd.shape[0], 1)) @ params["embed_e"]
        h, e = _layer_groups(
            cfg, lambda st, p: _gatedgcn_layer(p, *st, snd, rcv, n, ax),
            (h, e), params["layers"])
        return h @ params["readout"]
    if cfg.kind == "sage":
        L = len(params["layers"])
        for i, p in enumerate(params["layers"]):
            h_new = _sage_layer(p, h, h, snd, rcv, n, ax)
            h = F.relu(h_new) if i < L - 1 else h_new
        return h
    raise ValueError(cfg.kind)


def _forward_minibatch(cfg: GNNConfig, params: dict, batch: dict):
    """Layered blocks from the neighbor sampler (deepest block first);
    block i's dst count is ``len(receivers) // fanout`` with the fanouts
    of ``cfg.sample_sizes`` reversed."""
    h = batch["feats"]
    if cfg.kind != "sage":
        raise ValueError("minibatch blocks are a GraphSAGE path")
    fanouts = tuple(reversed(cfg.sample_sizes))
    L = len(params["layers"])
    for i, (p, blk) in enumerate(zip(params["layers"], batch["blocks"])):
        n_dst = blk["receivers"].shape[0] // fanouts[i]
        h_new = _sage_layer(p, h[:n_dst], h, blk["senders"].long(),
                            blk["receivers"], n_dst)
        h = F.relu(h_new) if i < L - 1 else h_new
    return h


def _forward_graphcast(cfg: GNNConfig, params: dict, batch: dict, ax):
    """Encoder (grid->mesh), processor (mesh), decoder (mesh->grid);
    ``mesh_feats [n_mesh, F]`` fixes ``n_mesh``.

    Under ``cfg.grid_sharded`` the grid arrays and the grid-incident
    edges are this rank's rows with local grid ids, the mesh state and
    the mesh edges every rank's: g2m sums over ``ax``, the processor
    aggregates locally (its edges are replicated: a sum would count them
    once per rank) and the decoder writes the rank's own grid rows."""
    hg = _mlp(params["embed_grid"], batch["feats"])          # [Ng, d]
    hm = _mlp(params["embed_mesh"], batch["mesh_feats"])     # [Nm, d]
    n_mesh = hm.shape[0]

    def edges(name):
        return batch[f"{name}_senders"].long(), batch[f"{name}_receivers"]

    def edge_embed(name, snd):
        return _mlp(params[f"embed_e_{name}"], hg.new_ones((snd.shape[0], 1)))
    g2m_s, g2m_r = edges("g2m")
    hm, _ = _interaction(params["g2m"], hg, hm, edge_embed("g2m", g2m_s),
                         g2m_s, g2m_r, n_mesh, ax)
    ax_grid = LOCAL if cfg.grid_sharded else ax
    m_s, m_r = edges("mesh")
    hm, _ = _layer_groups(
        cfg, lambda st, p: _interaction(p, st[0], st[0], st[1], m_s, m_r,
                                        n_mesh, ax_grid),
        (hm, edge_embed("mesh", m_s)), params["processor"])
    m2g_s, m2g_r = edges("m2g")
    hg2, _ = _interaction(params["m2g"], hm, hg, edge_embed("m2g", m2g_s),
                          m2g_s, m2g_r, hg.shape[0], ax_grid)
    return _mlp(params["readout"], hg2)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
_MESH_EDGES = {"g2m": ("n", "m"), "mesh": ("m", "m"), "m2g": ("m", "n")}


def _offset(idx, n_local, B, trash):
    """``[B, E]`` local ids -> one flat id array over ``B`` graphs of
    ``n_local`` nodes each.  Senders (``trash=False``) are clamped into
    their graph, as jax's gather clamps; receivers outside ``[0,
    n_local)`` go to ``B * n_local`` (the batch's trash row)."""
    idx = idx.long()
    off = torch.arange(B, device=idx.device)[:, None] * n_local
    if trash:
        ok = (idx >= 0) & (idx < n_local)
        return torch.where(ok, idx + off, B * n_local).reshape(-1)
    return (idx.clamp(0, n_local - 1) + off).reshape(-1)


def _batched_molecules(cfg: GNNConfig, batch: dict) -> dict:
    """The molecule batch as one graph of ``B * n`` nodes (for GraphCast,
    each graph with its own copy of the shared mesh)."""
    feats = batch["feats_batched"]
    B, n = feats.shape[:2]
    out = dict(feats=feats.reshape(B * n, -1),
               senders=_offset(batch["senders_b"], n, B, False),
               receivers=_offset(batch["receivers_b"], n, B, True))
    if cfg.kind == "graphcast":
        mesh = batch["mesh_feats"]
        nm = mesh.shape[0]
        out["mesh_feats"] = mesh.repeat(B, 1)
        sizes = {"n": n, "m": nm}
        for name, (src, dst) in _MESH_EDGES.items():
            for side, key, trash in (("senders", src, False),
                                     ("receivers", dst, True)):
                ids = batch[f"{name}_{side}"]
                out[f"{name}_{side}"] = _offset(
                    ids[None].expand(B, -1), sizes[key], B, trash)
    return out


def train_loss(cfg: GNNConfig, params: dict, batch: dict,
               mesh=None) -> torch.Tensor:
    """The reference's loss (``mesh`` as in ``forward``)."""
    if "feats_batched" in batch:      # molecule: graph-level regression
        B, n = batch["feats_batched"].shape[:2]
        out = forward(cfg, params, _batched_molecules(cfg, batch),
                      mesh=mesh)
        pred = out.reshape(B, n, -1).mean(dim=1)             # [B, C]
        return ((pred - batch["graph_label"]) ** 2).mean(dim=-1).mean()
    out = forward(cfg, params, batch, mesh=mesh)
    if cfg.kind == "graphcast":
        return torch.mean((out - batch["target"]) ** 2)
    labels = batch["labels"]
    if out.shape[0] != labels.shape[0]:   # minibatch: seeds only
        out = out[:labels.shape[0]]
    return softmax_xent(out, labels, batch.get("train_mask"))

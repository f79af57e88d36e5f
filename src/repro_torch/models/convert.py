"""Building the port's models from weights (no JAX counterpart).

* ``tree_from_numpy`` takes a reference parameter pytree as numpy arrays
  (the LM's ``init_params`` tree, per-layer arrays stacked on a leading
  ``[L]`` axis, or a GNN's) and returns the same tree of torch tensors:
  ``transformer.forward`` / ``train_loss`` and ``gnn`` take it as it is.
  ``lm_from_numpy`` builds a serving ``TransformerLM`` over such a tree,
  ``recsys_from_numpy`` DCN-v2's tree; the tests and ``chip_smoke.py``
  feed both packages the same arrays this way.
* ``numpy_params`` / ``numpy_recsys_params`` / ``numpy_gnn_params`` make
  such pytrees from a numpy seed, for runs that have no JAX (the card
  tests and ``chip_smoke.py``).
* ``init_lm_params`` draws the LM tree from a ``torch.Generator`` (the
  training launcher's f32 state); ``init_lm`` / ``init_recsys`` /
  ``init_gnn`` make random weights at full width directly on the card,
  one tensor at a time in the target dtype: a full-width f32 copy of
  Gemma-2-27B would be 109 GB.

On a model mesh, ``shard_lm_tree`` turns the reference's numpy tree into
one rank's pieces (``dist.sharding.lm_param_shardings``) and
``gather_lm_tree`` gathers them back, in full, on rank 0;
``init_lm_params(..., mesh=)`` keeps only this rank's pieces of the
same draws.

Every dense weight is drawn with its fan-in on axis 0, as the
reference's ``dense_init`` (default ``in_axis=0``) draws it.  For the MoE
expert weights ``[E_pad, d, d_expert]`` (``init_moe_params``) that axis
is the expert axis, so their scale is ``E_pad ** -0.5``, not ``d **
-0.5``; the port reproduces that, since it is what the reference
computes.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dist.sharding import (lm_param_shardings, local_shape,
                              recsys_param_shardings, shard, unshard)
from ..train import pytree
from . import gnn
from .layers import dense_init, embed_init
from .recsys import RecsysConfig
from .transformer import (LMConfig, TransformerLM, abstract_params,
                          layer_shapes)


def tree_from_numpy(params, device="cuda", dtype=torch.float32):
    """A parameter pytree of numpy arrays (nested dicts / lists, the
    reference's layout) -> the same tree of torch tensors on ``device``
    in ``dtype``."""
    return pytree.tree_map(lambda a: torch.as_tensor(np.array(a)).to(
        device=device, dtype=dtype), params)


def lm_from_numpy(cfg: LMConfig, params: dict, device="cuda",
                  dtype=torch.float32) -> TransformerLM:
    """The reference's parameter pytree (numpy) -> ``TransformerLM``."""
    return TransformerLM.from_tree(cfg, tree_from_numpy(params, device,
                                                        dtype))


def numpy_params(cfg: LMConfig, seed: int) -> dict:
    """A reference-layout pytree of f32 numpy arrays from ``seed``.

    Dense weights are ``N(0, 1)`` clipped to +-3 over ``sqrt(fan_in)``
    (fan-in on axis 0, as in the module docstring),
    the embedding ``N(0, 0.02^2)``, and the norms (zero at the
    reference's init) ``N(0, 0.1^2)``, so a comparison also sees every
    norm weight.
    """
    r = np.random.default_rng(seed)

    def draw(shape):
        if len(shape) == 1:
            return r.normal(0.0, 0.1, shape)
        return np.clip(r.standard_normal(shape), -3, 3) * shape[0] ** -0.5
    L, d = cfg.n_layers, cfg.d_model
    layers = {name: np.stack([draw(shape) for _ in range(L)])
              for name, shape in layer_shapes(cfg).items()}
    params = dict(embed=r.normal(0.0, 0.02, (cfg.vocab, d)),
                  final_norm=draw((d,)), layers=layers)
    if not cfg.tie_embeddings:
        params["unembed"] = draw((d, cfg.vocab))
    f32 = {k: v.astype(np.float32) for k, v in params.items()
           if k != "layers"}
    f32["layers"] = {k: v.astype(np.float32) for k, v in layers.items()}
    return f32


def init_lm_params(cfg: LMConfig, seed: int, device="cuda",
                   dtype=torch.float32, mesh=None) -> dict:
    """The reference's ``init_params`` tree drawn as it draws it
    (truncated-normal fan-in dense, fan-in on axis 0 as in the module
    docstring, ``N(0, 0.02^2)`` embedding, zero norms), from a
    ``torch.Generator`` on ``device``: the embedding, then each layer's
    weights in ``layer_shapes`` order, then the unembedding, each drawn
    in f32 and cast to ``dtype`` into its slot before the next is made.

    With ``mesh`` (a ``launch.mesh.ModelMesh``) every rank makes the
    same draws and keeps its pieces under ``lm_param_shardings``: equal
    to ``shard`` of the meshless tree, one layer's full weight alive at
    a time.  ``device`` is then the mesh's device."""
    device = torch.device(device if mesh is None else mesh.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kw = dict(dtype=dtype, device=device)
    d, L = cfg.d_model, cfg.n_layers
    specs = (None if mesh is None
             else lm_param_shardings(cfg, abstract_params(cfg), mesh))

    def keep(x, spec):
        return x if mesh is None else shard(x, spec, mesh)
    embed = keep(embed_init((cfg.vocab, d), gen, **kw),
                 specs and specs["embed"])
    shapes = layer_shapes(cfg)
    layers = {}
    for name, shape in shapes.items():
        spec = specs and specs["layers"][name]
        local = (shape if mesh is None
                 else local_shape((L,) + shape, spec, mesh)[1:])
        layers[name] = torch.zeros((L,) + tuple(local), **kw)
    for i in range(L):
        for name, shape in shapes.items():
            if len(shape) > 1:
                w = dense_init(shape, gen, **kw)
                if mesh is not None:
                    w = shard(w[None], specs["layers"][name], mesh)[0]
                layers[name][i] = w
    params = dict(embed=embed, final_norm=torch.zeros((d,), **kw),
                  layers=layers)
    if not cfg.tie_embeddings:
        params["unembed"] = keep(dense_init((d, cfg.vocab), gen, **kw),
                                 specs and specs["unembed"])
    return params


def shard_lm_tree(cfg: LMConfig, params: dict, mesh, shardings=None,
                  device=None, dtype=torch.float32) -> dict:
    """The reference's parameter tree (numpy) -> this rank's pieces as
    tensors on ``device`` (default the mesh's), under ``shardings``
    (default ``lm_param_shardings``)."""
    if shardings is None:
        shardings = lm_param_shardings(cfg, abstract_params(cfg), mesh)
    device = mesh.device if device is None else device
    return pytree.tree_map(
        lambda a, spec: shard(torch.as_tensor(np.array(a), dtype=dtype),
                              spec, mesh).to(device), params, shardings)


def gather_lm_tree(cfg: LMConfig, tree: dict, mesh,
                   shardings=None) -> dict | None:
    """The inverse of ``shard_lm_tree``: every rank's pieces gathered in
    full (a collective: every rank calls it), as the reference's numpy
    tree on rank 0 and None on the other ranks."""
    if shardings is None:
        shardings = lm_param_shardings(cfg, abstract_params(cfg), mesh)
    full = pytree.tree_map(
        lambda x, spec: unshard(x.detach(), spec, mesh).cpu().numpy(),
        tree, shardings)
    return full if mesh.rank == 0 else None


def init_lm(cfg: LMConfig, seed: int, device="cuda",
            dtype=torch.bfloat16) -> TransformerLM:
    """A serving model over ``init_lm_params(cfg, seed, device, dtype)``."""
    return TransformerLM.from_tree(cfg, init_lm_params(cfg, seed, device,
                                                       dtype))


def recsys_from_numpy(cfg: RecsysConfig, params: dict, device="cuda",
                      dtype=torch.float32) -> dict:
    """The reference's DCN-v2 pytree (numpy) -> the port's (torch tensors
    on ``device`` in ``dtype``; keep ``dtype`` the compute dtype)."""
    def t(a):
        return torch.as_tensor(np.array(a)).to(device=device, dtype=dtype)

    def wb(p):
        return dict(W=t(p["W"]), b=t(p["b"]))
    return dict(table=t(params["table"]),
                cross=[wb(p) for p in params["cross"]],
                mlp=[wb(p) for p in params["mlp"]], head=wb(params["head"]),
                retrieval_proj=t(params["retrieval_proj"]))


def _recsys_shapes(cfg: RecsysConfig):
    """(cross, mlp) layer shapes, head and projection shapes."""
    D = cfg.d_interact
    dims = (D,) + cfg.mlp
    return ([(D, D)] * cfg.n_cross_layers, list(zip(dims[:-1], dims[1:])),
            (cfg.mlp[-1], 1), (cfg.mlp[-1], cfg.embed_dim))


def numpy_recsys_params(cfg: RecsysConfig, seed: int) -> dict:
    """A reference-layout DCN-v2 pytree of f32 numpy arrays from ``seed``:
    the table ``N(0, 0.01^2)``, dense weights ``N(0, 1)`` clipped to +-3
    over ``sqrt(fan_in)``, and biases (zero at the reference's init)
    ``N(0, 0.1^2)``, so a comparison also sees every bias."""
    r = np.random.default_rng(seed)
    cross, mlp, head, proj = _recsys_shapes(cfg)

    def wb(shape):
        W = np.clip(r.standard_normal(shape), -3, 3) * shape[0] ** -0.5
        return dict(W=W.astype(np.float32),
                    b=r.normal(0.0, 0.1, shape[1]).astype(np.float32))
    table = r.normal(0.0, 0.01, (cfg.v_total, cfg.embed_dim))
    return dict(table=table.astype(np.float32),
                cross=[wb(s) for s in cross], mlp=[wb(s) for s in mlp],
                head=wb(head),
                retrieval_proj=(np.clip(r.standard_normal(proj), -3, 3)
                                * proj[0] ** -0.5).astype(np.float32))


def abstract_recsys(cfg: RecsysConfig) -> dict:
    """The DCN-v2 tree as meta tensors (the shapes
    ``recsys_param_shardings`` reads)."""
    cross, mlp, head, proj = _recsys_shapes(cfg)

    def t(*shape):
        return torch.empty(shape, device="meta")

    def wb(shape):
        return dict(W=t(*shape), b=t(shape[1]))
    return dict(table=t(cfg.v_total, cfg.embed_dim),
                cross=[wb(x) for x in cross], mlp=[wb(x) for x in mlp],
                head=wb(head), retrieval_proj=t(*proj))


def init_recsys(cfg: RecsysConfig, seed: int, device="cuda",
                dtype=torch.bfloat16, mesh=None) -> dict:
    """Random DCN-v2 weights as the reference's ``init_params`` draws them
    (table ``N(0, 0.01^2)``, truncated-normal fan-in dense weights, zero
    biases), from a ``torch.Generator`` on ``device``, each tensor drawn
    in f32 and cast to ``dtype`` before the next is made.  With ``mesh``
    every rank makes the same draws and keeps its rows of the table
    (``recsys_param_shardings``) on the mesh's device."""
    device = torch.device(device if mesh is None else mesh.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kw = dict(dtype=dtype, device=device)
    cross, mlp, head, proj = _recsys_shapes(cfg)
    table = torch.randn((cfg.v_total, cfg.embed_dim), generator=gen,
                        dtype=torch.float32, device=device)
    if mesh is not None:
        spec = recsys_param_shardings(abstract_recsys(cfg), mesh)["table"]
        table = shard(table, spec, mesh)
    table = table.mul_(0.01).to(dtype)

    def wb(shape):
        return dict(W=dense_init(shape, gen, **kw),
                    b=torch.zeros(shape[1], **kw))
    return dict(table=table, cross=[wb(s) for s in cross],
                mlp=[wb(s) for s in mlp], head=wb(head),
                retrieval_proj=dense_init(proj, gen, **kw))


def numpy_gnn_params(cfg: gnn.GNNConfig, d_in: int, d_out: int,
                     seed: int) -> dict:
    """A reference-layout GNN pytree of f32 numpy arrays from ``seed``:
    matrices ``N(0, 1)`` clipped to +-3 over ``sqrt(fan_in)`` (fan-in on
    axis 0), biases and LayerNorm shifts ``N(0, 0.1^2)``, LayerNorm
    scales ``1 + N(0, 0.1^2)`` (zero and one at the reference's init), so
    a comparison sees every parameter."""
    r = np.random.default_rng(seed)

    def draw(path, shape):
        if len(shape) == 2:
            a = np.clip(r.standard_normal(shape), -3, 3) * shape[0] ** -0.5
        else:
            scale = path.endswith(("'ln_h_s']", "'ln_e_s']"))
            a = float(scale) + r.normal(0.0, 0.1, shape)
        return a.astype(np.float32)
    return gnn.map_shapes(draw, gnn.param_shapes(cfg, d_in, d_out))


def init_gnn(cfg: gnn.GNNConfig, d_in: int, d_out: int, seed: int,
             device="cuda", dtype=torch.float32) -> dict:
    """Random GNN weights as the reference's ``init_params`` draws them
    (``gnn.init_params``) from a ``torch.Generator`` seeded with
    ``seed`` on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gnn.init_params(cfg, d_in, d_out, gen, dtype=dtype,
                           device=device)

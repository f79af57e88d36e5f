"""Placement builders for every model family (the port's copy of
``repro.dist.sharding``), and the leaf-level shard / unshard of a
``launch.mesh.ModelMesh``.

A mesh here is any object with ``axis_names`` and a ``shape`` mapping
axis name to extent (``launch.mesh.EstimatorMesh``, ``ModelMesh``).

The reference's builders return ``NamedSharding`` trees; the port's
return a ``PartitionSpec`` per leaf, its counterpart: per dimension
``None`` (replicated), an axis name, or a tuple of axes (sharded over
their product, row-major).  Same conventions as the reference:

* ``data_axes(mesh)`` is a **tuple** of the axes carrying data
  parallelism -- ``("data",)``, or ``("pod", "data")`` when a pod axis
  exists -- used directly as a spec entry;
* tensor parallelism lives on ``"model"`` (Megatron layout: column-
  parallel in-projections, row-parallel out-projections, experts over
  ``"model"`` for EP, embeddings over the vocabulary);
* every builder guards on divisibility (``_dim``): a dimension that does
  not divide its axes is replicated instead.

``shard(full, spec, mesh)`` cuts a rank's piece out of a full leaf and
``unshard(local, spec, mesh)`` all-gathers the full leaf back on every
rank; the checkpoints and the tests use them.
"""
from __future__ import annotations

import math

import torch

from ..train import pytree
from ..train.optimizer import AdamState


class PartitionSpec:
    """Per dimension ``None``, an axis name or a tuple of axes; trailing
    dimensions not named are replicated.  A leaf of ``train.pytree``
    (not a tuple), so a tree of specs mirrors its parameter tree."""

    __slots__ = ("dims",)

    def __init__(self, *dims):
        self.dims = tuple(dims)

    def __iter__(self):
        return iter(self.dims)

    def __len__(self) -> int:
        return len(self.dims)

    def __getitem__(self, i):
        return self.dims[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and self.dims == other.dims

    def __hash__(self) -> int:
        return hash(self.dims)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.dims!r}"

    def padded(self, ndim: int) -> tuple:
        """The entries for a leaf of ``ndim`` dimensions."""
        if len(self.dims) > ndim:
            raise ValueError(f"{self} names more than {ndim} dimensions")
        return self.dims + (None,) * (ndim - len(self.dims))


P = PartitionSpec


# ---------------------------------------------------------------------------
# mesh introspection
# ---------------------------------------------------------------------------
def data_axes(mesh) -> tuple:
    """Axis names carrying data parallelism (pod folds into data)."""
    names = [a for a in ("pod", "data") if a in mesh.axis_names]
    return tuple(names) if names else tuple(
        a for a in mesh.axis_names if a != "model")[:1]


def n_data(mesh) -> int:
    axes = data_axes(mesh)
    return math.prod(int(mesh.shape[a]) for a in axes) if axes else 1


def n_model(mesh) -> int:
    return int(mesh.shape["model"]) if "model" in mesh.axis_names else 1


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(int(mesh.shape[a]) for a in axes)


def _dim(mesh, size: int, axes):
    """``axes`` if ``size`` divides their product, else None (replicate)."""
    if axes is None:
        return None
    if size % _axis_size(mesh, axes) == 0:
        return axes
    return None


def replicated(mesh) -> PartitionSpec:
    return P()


# ---------------------------------------------------------------------------
# LM params (Megatron TP + EP)
# ---------------------------------------------------------------------------
def lm_param_shardings(cfg, params, mesh) -> dict:
    """A ``PartitionSpec`` per leaf of the LM parameter tree (leaves
    with a ``.shape``: tensors, meta tensors from
    ``transformer.abstract_params``)."""
    m = "model"

    def layer_spec(name: str, leaf):
        shp = leaf.shape
        if name in ("wq", "wk", "wv"):            # [L, d, H*hd] col-parallel
            return P(None, None, _dim(mesh, shp[2], m))
        if name == "wo":                          # [L, H*hd, d] row-parallel
            return P(None, _dim(mesh, shp[1], m), None)
        if name in ("w_gate", "w_up", "shared_gate", "shared_up"):
            return P(None, None, _dim(mesh, shp[2], m))
        if name in ("w_down", "shared_down"):
            return P(None, _dim(mesh, shp[1], m), None)
        if name in ("moe_gate", "moe_up", "moe_down"):  # [L, E, ., .] EP
            return P(None, _dim(mesh, shp[1], m), None, None)
        return P()                                # norms, router

    out = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = {n: layer_spec(n, leaf) for n, leaf in v.items()}
        elif k == "embed":                        # [V, d] vocab-sharded
            out[k] = P(_dim(mesh, v.shape[0], m), None)
        elif k == "unembed":                      # [d, V]
            out[k] = P(None, _dim(mesh, v.shape[1], m))
        else:                                     # final_norm etc.
            out[k] = replicated(mesh)
    return out


def lm_batch_shardings(mesh) -> dict:
    sh = P(data_axes(mesh), None)
    return dict(tokens=sh, labels=sh, mask=sh)


# ---------------------------------------------------------------------------
# optimizer state
# ---------------------------------------------------------------------------
def opt_state_shardings(p_sh, mesh, params=None,
                        zero: bool = False) -> AdamState:
    """AdamState specs mirroring the param specs.

    ``zero=True`` (ZeRO) additionally shards each moment leaf's first
    still-replicated dimension that the data axes divide over them --
    the moments are 2x the params in f32, so sharding them over data is
    the big memory win.  Needs ``params`` (shapes) to check
    divisibility.
    """
    da = data_axes(mesh)
    nd = _axis_size(mesh, da)

    def moment_spec(sh: PartitionSpec, leaf):
        if not zero or params is None:
            return sh
        spec = list(sh.padded(len(leaf.shape)))
        for i, (entry, size) in enumerate(zip(spec, leaf.shape)):
            if entry is None and nd > 1 and size % nd == 0:
                spec[i] = da
                return P(*spec)
        return sh

    mu = p_sh if params is None else pytree.tree_map(moment_spec, p_sh,
                                                      params)
    return AdamState(step=replicated(mesh), mu=mu, nu=mu)


# ---------------------------------------------------------------------------
# GNN / recsys
# ---------------------------------------------------------------------------
def gnn_param_shardings(params, mesh):
    """GNN weight matrices are tiny relative to activations: replicate."""
    return pytree.tree_map(lambda _: replicated(mesh), params)


def _leading_dim_sharding(mesh, leaf) -> PartitionSpec:
    da = data_axes(mesh)
    ndim = len(leaf.shape)
    if ndim == 0 or not da:
        return replicated(mesh)
    return P(_dim(mesh, leaf.shape[0], da), *([None] * (ndim - 1)))


def gnn_batch_shardings(mesh, batch):
    """Shard node/edge arrays over data when the leading dim divides."""
    return pytree.tree_map(lambda leaf: _leading_dim_sharding(mesh, leaf),
                           batch)


def recsys_param_shardings(params, mesh):
    out = pytree.tree_map(lambda _: replicated(mesh), params)
    table = params["table"]                       # [v_total, d] row-sharded
    out["table"] = P(_dim(mesh, table.shape[0], "model"), None)
    return out


def recsys_batch_shardings(mesh, batch) -> dict:
    out = {}
    for k, leaf in batch.items():
        if k == "cand_ids":
            out[k] = replicated(mesh)
        else:
            out[k] = _leading_dim_sharding(mesh, leaf)
    return out


# ---------------------------------------------------------------------------
# one rank's piece of a leaf, and back
# ---------------------------------------------------------------------------
def local_shape(shape, spec: PartitionSpec, mesh) -> tuple:
    """The shape of a rank's piece of a leaf of ``shape``."""
    out = []
    for size, axes in zip(shape, spec.padded(len(shape))):
        n = _axis_size(mesh, axes)
        if size % n:
            raise ValueError(f"dimension {size} does not divide {axes} "
                             f"({n} ranks)")
        out.append(size // n)
    return tuple(out)


def shard(full: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """This rank's piece of ``full`` under ``spec`` (a copy: the full
    leaf can be freed)."""
    out = full
    for dim, axes in enumerate(spec.padded(full.dim())):
        if axes is None:
            continue
        n = mesh.extent(axes)
        if full.shape[dim] % n:
            raise ValueError(f"dimension {full.shape[dim]} does not divide "
                             f"{axes} ({n} ranks)")
        size = full.shape[dim] // n
        out = out.narrow(dim, mesh.coord(axes) * size, size)
    return out.clone(memory_format=torch.contiguous_format)


@torch.no_grad()
def unshard(local: torch.Tensor, spec: PartitionSpec,
            mesh) -> torch.Tensor:
    """The full leaf, all-gathered from every rank's piece (a collective
    over each sharded dimension's axes: every rank calls it)."""
    from .collectives import all_gather_dim
    out = local
    for dim, axes in enumerate(spec.padded(local.dim())):
        if axes is not None:
            out = all_gather_dim(out, dim, mesh.group(axes))
    return out


def shard_tree(tree, specs, mesh):
    """``shard`` over every leaf of ``tree`` with the matching spec."""
    return pytree.tree_map(lambda x, s: shard(x, s, mesh), tree, specs)


def unshard_tree(tree, specs, mesh):
    """``unshard`` over every leaf of ``tree`` with the matching spec."""
    return pytree.tree_map(lambda x, s: unshard(x, s, mesh), tree, specs)

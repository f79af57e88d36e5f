"""The port's placement builders (``repro_torch.dist.sharding``) against
the reference's, leaf by leaf, with no process group.

The reference's ``NamedSharding`` trees are built on a
``jax.sharding.AbstractMesh`` of the same axes (no devices needed); the
port's on a stand-in with ``axis_names`` and ``shape``.  An entry is
compared as the tuple of axes it names (jax writes a one-axis tuple as
the name), so ``("data",)`` and ``"data"`` agree.  Also: the model
mesh's argument checks, which raise before any process group is joined,
and ``local_shape`` / ``shard`` on one rank's coordinates.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.dist import sharding as jshd
from repro.models import transformer as jt
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import transformer as tt
from repro_torch.train import pytree

LM_IDS = ("granite-8b", "gemma2-27b", "deepseek-7b", "qwen2-moe-a2.7b",
          "granite-moe-3b-a800m")
MESHES = [(("data", "model"), (2, 2)), (("data", "model"), (4, 1)),
          (("data", "model"), (1, 4)), (("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16)),
          (("pod", "data", "model"), (2, 3, 2))]


@dataclass
class Shape:
    """A stand-in mesh: the port's builders read only these."""
    axis_names: tuple
    dims: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))

    def extent(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else axes
        return int(np.prod([self.shape[a] for a in axes]))


def _entry(e) -> tuple:
    if e is None:
        return ()
    return (e,) if isinstance(e, str) else tuple(e)


def _spec(spec, ndim) -> tuple:
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return tuple(_entry(e) for e in entries)


def _hold(mine, ref, shapes):
    """Every leaf's spec equal, by path, in jax's leaf order."""
    got = pytree.flatten_with_paths(mine)
    want = jax.tree_util.tree_flatten_with_path(
        ref, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    dims = [len(s.shape) for s in pytree.leaves(shapes)]
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, a), (_, b), nd in zip(got, want, dims, strict=True):
        assert _spec(a, nd) == _spec(b.spec, nd), path


def _meshes(axes, dims):
    return Shape(axes, dims), AbstractMesh(dims, axes)


@pytest.mark.parametrize("axes,dims", MESHES)
@pytest.mark.parametrize("arch", LM_IDS)
def test_lm_param_and_opt_specs_are_the_references(arch, axes, dims):
    """``lm_param_shardings`` and ``opt_state_shardings`` (zero off and
    on) for the full config, and for the smoke config on the small
    meshes: every leaf's spec is the reference's."""
    mine_mesh, ref_mesh = _meshes(axes, dims)
    pairs = [(get_config(arch), jax_config(arch))]
    if max(dims) <= 4:
        pairs.append((get_smoke_config(arch), jax_smoke(arch)))
    for cfg, jcfg in pairs:
        shapes, jshapes = tt.abstract_params(cfg), jt.abstract_params(jcfg)
        assert [tuple(x.shape) for x in pytree.leaves(shapes)] == [
            tuple(x.shape) for x in jax.tree.leaves(jshapes)]
        p = shd.lm_param_shardings(cfg, shapes, mine_mesh)
        jp = jshd.lm_param_shardings(jcfg, jshapes, ref_mesh)
        _hold(p, jp, shapes)
        for zero in (False, True):
            o = shd.opt_state_shardings(p, mine_mesh, shapes, zero=zero)
            jo = jshd.opt_state_shardings(jp, ref_mesh, jshapes, zero=zero)
            _hold(o.mu, jo.mu, shapes)
            _hold(o.nu, jo.nu, shapes)
            assert _spec(o.step, 0) == _spec(jo.step.spec, 0)


@pytest.mark.parametrize("axes,dims", MESHES)
def test_batch_gnn_and_recsys_specs_are_the_references(axes, dims):
    mine_mesh, ref_mesh = _meshes(axes, dims)
    b = shd.lm_batch_shardings(mine_mesh)
    jb = jshd.lm_batch_shardings(ref_mesh)
    assert {k: _spec(v, 2) for k, v in b.items()} == {
        k: _spec(v.spec, 2) for k, v in jb.items()}
    rng = np.random.default_rng(0)
    gnn_params = {"layers": [{"W": rng.random((8, 4)), "b": rng.random(4)}],
                  "out": rng.random((4, 3))}
    gnn_batch = {"x": rng.random((96, 5)), "senders": np.zeros(512, int),
                 "n": np.zeros(()), "odd": rng.random((7, 2))}
    rec_params = {"table": rng.random((1024, 4)),
                  "mlp": [rng.random((4, 4))]}
    rec_batch = {"dense": rng.random((64, 13)), "cand_ids": np.zeros(33),
                 "label": rng.random(30)}
    for mine, ref, tree in (
            (shd.gnn_param_shardings(gnn_params, mine_mesh),
             jshd.gnn_param_shardings(gnn_params, ref_mesh), gnn_params),
            (shd.gnn_batch_shardings(mine_mesh, gnn_batch),
             jshd.gnn_batch_shardings(ref_mesh, gnn_batch), gnn_batch),
            (shd.recsys_param_shardings(rec_params, mine_mesh),
             jshd.recsys_param_shardings(rec_params, ref_mesh), rec_params),
            (shd.recsys_batch_shardings(mine_mesh, rec_batch),
             jshd.recsys_batch_shardings(ref_mesh, rec_batch), rec_batch)):
        _hold(mine, ref, tree)
    assert shd.replicated(mine_mesh) == shd.P()
    assert shd.data_axes(mine_mesh) == jshd.data_axes(ref_mesh)
    assert shd.n_data(mine_mesh) == jshd.n_data(ref_mesh)
    assert shd.n_model(mine_mesh) == jshd.n_model(ref_mesh)


class OneRank(Shape):
    """A stand-in mesh seen from one rank at ``coords``."""

    def __init__(self, axis_names, dims, coords):
        super().__init__(axis_names, dims)
        self.coords = coords

    def coord(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else axes
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx


def test_shard_pieces_tile_the_leaf():
    """Over every rank of a (pod 2, data 2, model 2) mesh the pieces of
    a leaf sharded on dim 0 over the data axes and on dim 2 over model
    tile it exactly once; ``local_shape`` is the pieces' shape."""
    axes, dims = ("pod", "data", "model"), (2, 2, 2)
    full = torch.arange(8 * 3 * 6, dtype=torch.float32).reshape(8, 3, 6)
    spec = shd.P(("pod", "data"), None, "model")
    seen = torch.zeros_like(full)
    for p in range(2):
        for d in range(2):
            for m in range(2):
                mesh = OneRank(axes, dims, dict(pod=p, data=d, model=m))
                piece = shd.shard(full, spec, mesh)
                assert piece.shape == shd.local_shape(full.shape, spec, mesh)
                rows = slice((2 * p + d) * 2, (2 * p + d) * 2 + 2)
                cols = slice(3 * m, 3 * m + 3)
                assert torch.equal(piece, full[rows, :, cols])
                seen[rows, :, cols] += 1
    assert bool((seen == 1).all())
    with pytest.raises(ValueError, match="does not divide"):
        shd.local_shape((6, 3), shd.P(None, "model"),
                        OneRank(axes, dims, dict(pod=0, data=0, model=0)))


def test_model_mesh_checks_its_arguments():
    """Before any process group is joined: the world must be the mesh's
    product, the backend named, nccl on the card, and the production
    meshes have 256 / 512 ranks."""
    kw = dict(rank=0, init_method="file:///nonexistent", device="cpu")
    with pytest.raises(ValueError, match="world size"):
        make_host_mesh(2, 2, world_size=3, backend="gloo", **kw)
    with pytest.raises(ValueError, match="backend"):
        make_host_mesh(2, 2, world_size=4, backend="mpi", **kw)
    with pytest.raises(ValueError, match="nccl needs"):
        make_host_mesh(2, 2, world_size=4, backend="nccl", **kw)
    with pytest.raises(ValueError, match="outside"):
        make_host_mesh(2, 2, world_size=4, backend="gloo",
                       **dict(kw, rank=4))
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh(world_size=8, backend="gloo", **kw)
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(True, world_size=256, backend="gloo", **kw)
    assert not torch.distributed.is_initialized()

"""The port's GNN minibatch and molecule paths, its ``NeighborSampler``,
segment primitives, new layers and GNN configs against the JAX package.

* ``NeighborSampler``: blocks bit-equal to the reference's from the same
  ``np.random.Generator`` (isolated nodes, fanouts wider than degrees).
* GraphSAGE on sampled blocks and the molecule path (GatedGCN, GAT and
  GraphCast over ``B`` graphs with pad edges, run by the port as one
  batched graph): loss and every gradient against ``jax.value_and_grad``,
  f32, 1e-5 relative to each leaf's largest magnitude.
* ``seg_sum`` / ``seg_mean`` / ``seg_max`` / ``edge_softmax`` with pad
  and negative receivers and empty segments (``-inf`` max), 1e-6.
* ``layer_norm``, ``gelu``, ``geglu``, ``softmax_xent`` (mask, z-loss),
  f32 1e-6 and bf16 to one rounding.
* The four GNN configs, ``get_skips``, ``shapes_for`` and ``cells``
  equal the reference registry's.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.graphs.neighbor_sampler import NeighborSampler as RefSampler
from repro.models import gnn as jg
from repro.models import layers as jl
from repro_torch.configs import get_smoke_config
from repro_torch.graphs import NeighborSampler
from repro_torch.models import gnn, layers
from repro_torch.testing import gnn_block_batch, gnn_molecule_batch

from test_torch_gnn import held


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_neighbor_sampler_blocks_bit_equal(seed):
    r = np.random.default_rng(seed)
    n, m = 50, 120
    # nodes 20-24 isolated (an isolated node past the last node with an
    # edge reads past the CSR in both packages)
    ids = np.r_[0:20, 25:n]
    snd, rcv = r.choice(ids, m), r.choice(ids, m)
    feats = r.standard_normal((n, 4)).astype(np.float32)
    labels = r.integers(0, 3, n)
    seeds = np.array([0, 3, n - 1, 21, 7])
    mine, ref = NeighborSampler(snd, rcv, n), RefSampler(snd, rcv, n)
    assert np.array_equal(mine.ptr, ref.ptr)
    assert np.array_equal(mine.nbr, ref.nbr)
    for fanouts in ((4, 3), (25, 10), (2,)):
        a = mine.sample_blocks(seeds, fanouts, np.random.default_rng(seed),
                               feats=feats, labels=labels)
        b = ref.sample_blocks(seeds, fanouts, np.random.default_rng(seed),
                              feats=feats, labels=labels)
        la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("n,size", [(1, 5), (7, 1000), (3000, 20000),
                                    (2**40, 50)])
def test_csr_order_is_the_stable_argsort(n, size):
    """The sampler's composite-key sort gives ``argsort(kind="stable")``
    (many duplicate ids; ids too wide for the keys take the argsort)."""
    from repro_torch.graphs.neighbor_sampler import _stable_order
    u = np.random.default_rng(n).integers(0, n, size)
    assert np.array_equal(_stable_order(u, n), np.argsort(u, kind="stable"))


@pytest.mark.parametrize("seed", [0, 1])
def test_minibatch_blocks_match_reference(seed):
    r = np.random.default_rng(seed)
    n = 80
    sampler = NeighborSampler(r.integers(0, n, 300), r.integers(0, n, 300),
                              n)
    feats = r.standard_normal((n, 6)).astype(np.float32)
    batch = gnn_block_batch(sampler, r, 8, (4, 3), feats,
                            r.integers(0, 3, n))
    assert [b["receivers"].shape[0] for b in batch["blocks"]] == [120, 32]
    held("graphsage-reddit", batch, 6, 3, seed)


@pytest.mark.parametrize("arch,n_pad", [("gatedgcn", 0), ("gatedgcn", 2),
                                        ("gat-cora", 0)])
def test_molecule_path_matches_reference_vmap(arch, n_pad):
    """(GAT with pad edges is left out: where a graph's last node has no
    in-edge, the reference's pad edges divide by a zero softmax sum and
    its gradients are NaN.)"""
    batch = gnn_molecule_batch(np.random.default_rng(n_pad), 6, 7, 12, 4, 1,
                               n_pad=n_pad)
    held(arch, batch, 4, 1, n_pad)


def test_graphcast_molecule_path_matches_reference_vmap():
    """GraphCast on molecules: every graph with its own copy of the
    shared mesh (the reference's vmap broadcasts it)."""
    r = np.random.default_rng(5)
    n, nm = 7, 3
    batch = gnn_molecule_batch(r, 5, n, 12, 4, 2)
    batch.update(
        mesh_feats=r.standard_normal((nm, 4)).astype(np.float32),
        g2m_senders=np.arange(n, dtype=np.int32),
        g2m_receivers=(np.arange(n) % nm).astype(np.int32),
        mesh_senders=r.integers(0, nm, 4 * nm).astype(np.int32),
        mesh_receivers=np.append(r.integers(0, nm, 4 * nm - 1),
                                 nm).astype(np.int32),
        m2g_senders=(np.arange(n) % nm).astype(np.int32),
        m2g_receivers=np.arange(n, dtype=np.int32))
    held("graphcast", batch, 4, 2, 5)


def test_sharded_axes_are_not_ported():
    """Edge axes need the mesh whose group combines the partial
    aggregates (the reference's ``shard_map`` supplies it; the port takes
    ``mesh=``): without one they are refused, and ``LOCAL`` (no axes)
    reduces nothing.  The mesh runs are ``test_torch_dist_gnn.py``."""
    cfg = dataclasses.replace(get_smoke_config("gatedgcn"),
                              shard_axes=("data",))
    x = torch.ones(3, 2)
    with pytest.raises(ValueError, match="need mesh="):
        gnn.EdgeAxes(None, ("data",))
    with pytest.raises(ValueError, match="need mesh="):
        gnn.forward(cfg, {}, {})
    got = gnn.seg_sum(x, torch.zeros(3, dtype=torch.long), 2,
                      axes=gnn.LOCAL)
    assert torch.equal(got, torch.tensor([[3.0, 3.0], [0.0, 0.0]]))


def test_segment_primitives_match_reference():
    r = np.random.default_rng(0)
    n, E, H = 6, 40, 3
    x = r.standard_normal((E, H)).astype(np.float32)
    idx = r.integers(0, n - 1, E)              # node n - 1 gets no edge ...
    idx[:4] = n                                # ... and four pad edges
    idx[4] = -3                                # a negative id is dropped too
    jx, ji = jnp.asarray(x), jnp.asarray(idx, jnp.int32)
    tx, ti = torch.as_tensor(x), torch.as_tensor(idx, dtype=torch.int32)
    for name in ("seg_sum", "seg_mean", "seg_max"):
        want = np.asarray(getattr(jg, name)(jx, ji, n))
        got = getattr(gnn, name)(tx, ti, n).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.isneginf(gnn.seg_max(tx, ti, n).numpy()[n - 1]).all()
    idx[4] = 0
    ji, ti = jnp.asarray(idx, jnp.int32), torch.as_tensor(idx)
    want = np.asarray(jg.edge_softmax(jx, ji, n))
    got = gnn.edge_softmax(tx, ti, n).numpy()
    real = idx < n
    np.testing.assert_allclose(got[real], want[real], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_new_layers_match_reference(dtype):
    r = np.random.default_rng(1)
    x = r.standard_normal((5, 16)).astype(np.float32)
    w = [r.standard_normal(s).astype(np.float32) * 0.3
         for s in ((16, 12), (16, 12), (12, 16))]
    s, b = (1 + 0.1 * r.standard_normal(16)).astype(np.float32), \
        r.standard_normal(16).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = 1e-6 if dtype == "float32" else 8e-3

    def T(a):
        return torch.as_tensor(a).to(tdt)

    def J(a):
        return jnp.asarray(a, jdt)
    pairs = [
        (layers.layer_norm(T(x), T(s), T(b)), jl.layer_norm(J(x), J(s),
                                                            J(b))),
        (layers.gelu(T(x)), jl.gelu(J(x))),
        (layers.geglu(T(x), *map(T, w)), jl.geglu(J(x), *map(J, w)))]
    for got, want in pairs:
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol * 4)
    logits = r.standard_normal((4, 6, 10)).astype(np.float32) * 3
    labels = r.integers(0, 10, (4, 6))
    mask = (r.random((4, 6)) < 0.5).astype(np.float32)
    for kw in (dict(), dict(mask=mask), dict(mask=mask, z_loss=1e-3),
               dict(mask=np.zeros_like(mask))):
        want = jl.softmax_xent(J(logits), jnp.asarray(labels),
                               **{k: (jnp.asarray(v) if k == "mask" else v)
                                  for k, v in kw.items()})
        got = layers.softmax_xent(T(logits), torch.as_tensor(labels),
                                  **{k: (torch.as_tensor(v) if k == "mask"
                                         else v) for k, v in kw.items()})
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-7)


def test_gnn_configs_and_registry_match_reference():
    from repro import configs as jc
    from repro_torch import configs as tc
    assert tc.ARCH_IDS == jc.ARCH_IDS
    for arch in ("gat-cora", "gatedgcn", "graphsage-reddit", "graphcast"):
        for mine, ref in ((tc.get_config(arch), jc.get_config(arch)),
                          (tc.get_smoke_config(arch),
                           jc.get_smoke_config(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    for arch in tc.ARCH_IDS:
        assert tc.get_skips(arch) == jc.get_skips(arch)
        assert tc.shapes_for(arch) == jc.shapes_for(arch)
    assert tc.cells() == jc.cells()
    assert tc.cells(include_skipped=True) == jc.cells(include_skipped=True)

"""Edge-parallel GNN training on a model mesh against the reference, on
CPU ranks over gloo (one spawn per world size, ``run_on_mesh``).

Every rank cuts its piece of the same numpy batch
(``dist.gnn_sharded.local_batch``), takes ``make_sharded_gnn_loss`` and
its gradient (``models.gnn`` with ``EdgeAxes`` over the data axes), and
the gradient is summed over the data axes as the step sums it.  The
parent holds the loss (1e-5 relative) and every gradient leaf (the
reference test's ``rtol 1e-4, atol 1e-5``) to ``jax.value_and_grad`` of
the reference's plain ``train_loss`` on the full batch, with the smoke
widths of the reference's own test (24 nodes, 64 edges, 2 layers of 8):

* gatedgcn on ``(pod=2, data=2, model=2)`` (the reference's case: the
  model ranks repeat the edge work), without remat and with
  ``remat_group=2`` over 4 layers; one ``make_train_step`` step cutting
  its own piece (``share``) equals the port's meshless step within 1e-5;
* gat (2 heads) and sage on ``(4, 1)`` and ``(2, 2)`` (node ``n - 1``
  has an in-edge: ROADMAP §3's NaN otherwise);
* graphcast ``grid_sharded`` on ``(4, 2)`` on the reference test's batch
  (grid ids local to each quarter, globalized for the port's cut and for
  the plain oracle: shard s's grid ids plus ``8 s``): its loss equals
  the reference's ``make_sharded_gnn_loss`` (a subprocess with 8 host
  devices) and the plain loss, every leaf the plain gradient.

The cut itself is checked without ranks: the pieces put back together
are the full batch.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import gnn as jg
from repro_torch.dist.gnn_sharded import local_batch
from repro_torch.launch.mesh import run_on_mesh
from repro_torch.models import gnn
from repro_torch.models.convert import numpy_gnn_params, tree_from_numpy
from repro_torch.testing import to_torch
from repro_torch.train import pytree
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.steps import make_train_step
from torch_dist_workers import gnn_cases

REPO = Path(__file__).resolve().parents[1]
N, E, F, C = 24, 64, 6, 3
NG, NM, FG, VARS = 32, 8, 5, 4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
BASE = dict(name="t", n_layers=2, d_hidden=8, remat=False)


def graph_batch(seed: int, gat: bool = False) -> dict:
    """The reference test's full-graph batch (every node in the mask)."""
    r = np.random.default_rng(seed)
    rcv = r.integers(0, N, E).astype(np.int32)
    if gat:
        rcv[0] = N - 1
    return dict(feats=r.standard_normal((N, F)).astype(np.float32),
                senders=r.integers(0, N, E).astype(np.int32),
                receivers=rcv,
                labels=r.integers(0, C, N).astype(np.int32),
                train_mask=np.ones((N,), np.float32))


def graphcast_batch() -> tuple[dict, dict]:
    """The reference test's grid-sharded batch (grid ids local to each
    of 4 shards) and the same batch with global grid ids."""
    r = np.random.default_rng(3)
    g2m_s = (np.arange(NG) % (NG // 4)).astype(np.int32)
    local = dict(
        feats=r.normal(size=(NG, FG)).astype(np.float32),
        mesh_feats=r.normal(size=(NM, FG)).astype(np.float32),
        g2m_senders=g2m_s,
        g2m_receivers=r.integers(0, NM, NG).astype(np.int32),
        mesh_senders=r.integers(0, NM, 4 * NM).astype(np.int32),
        mesh_receivers=r.integers(0, NM, 4 * NM).astype(np.int32),
        m2g_senders=r.integers(0, NM, NG).astype(np.int32),
        m2g_receivers=g2m_s,
        target=r.normal(size=(NG, VARS)).astype(np.float32),
        grid_mask=np.ones((NG,), np.float32))
    glob = dict(local)
    shift = (np.arange(NG) // (NG // 4) * (NG // 4)).astype(np.int32)
    for k in ("g2m_senders", "m2g_receivers"):
        glob[k] = local[k] + shift
    return local, glob


def case(name, dims, fields, batch, d_in, d_out, seed, step=False):
    cfg = gnn.GNNConfig(**{**BASE, **fields})
    return dict(name=name, dims=dims, cfg=dataclasses.asdict(cfg),
                params=numpy_gnn_params(cfg, d_in, d_out, seed),
                batch=batch, step=OPT if step else None)


def eight_rank_cases() -> list:
    _, glob = graphcast_batch()
    return [
        case("gatedgcn (2, 2, 2)", (2, 2, 2), dict(kind="gatedgcn"),
             graph_batch(2), F, C, 0, step=True),
        case("gatedgcn (2, 2, 2) remat", (2, 2, 2),
             dict(kind="gatedgcn", n_layers=4, remat=True, remat_group=2),
             graph_batch(4), F, C, 1),
        case("graphcast (4, 2) grid-sharded", (4, 2),
             dict(kind="graphcast", n_vars=VARS, mesh_ratio=4), glob, FG,
             VARS, 2)]


def four_rank_cases() -> list:
    out = []
    for kind, fields in (("gat", dict(kind="gat", n_heads=2)),
                         ("sage", dict(kind="sage"))):
        for i, dims in enumerate(((4, 1), (2, 2))):
            out.append(case(f"{kind} {dims}", dims, fields,
                            graph_batch(5 + i, gat=kind == "gat"), F, C,
                            3 + i))
    return out


def plain(c):
    """The reference's plain loss and gradient leaves on the full batch."""
    jcfg = jg.GNNConfig(**c["cfg"])
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jg.train_loss(jcfg, p, b)))(
        jax.tree.map(jnp.asarray, c["params"]),
        jax.tree.map(jnp.asarray, c["batch"]))
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def hold(c, got):
    loss, grads = plain(c)
    assert got["loss"] == pytest.approx(loss, rel=1e-5), c["name"]
    assert len(got["grads"]) == len(grads)
    for a, b in zip(got["grads"], grads):
        assert np.isfinite(b).all(), c["name"]
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                   err_msg=c["name"])


SUB = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp
from repro.dist.gnn_sharded import make_sharded_gnn_loss
from repro.models import gnn
params, batch = pickle.load(open(sys.argv[1], "rb"))
mesh = jax.make_mesh((4, 2), ("data", "model"))
cfg = gnn.GNNConfig(name="t", kind="graphcast", n_layers=2, d_hidden=8,
                    n_vars=4, mesh_ratio=4, remat=False)
p = jax.tree.map(jnp.asarray, params)
b = jax.tree.map(jnp.asarray, batch)
loss_sh = make_sharded_gnn_loss(cfg, mesh, b)
with mesh:
    print(repr(float(jax.jit(loss_sh)(p, b))))
"""


def reference_sharded_graphcast(tmp_path, params) -> float:
    """The reference's ``make_sharded_gnn_loss`` on its own test batch
    (grid-local ids), in a subprocess with 8 host devices."""
    local, _ = graphcast_batch()
    path = tmp_path / "graphcast.pkl"
    path.write_bytes(pickle.dumps((params, local)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                        str(path)], capture_output=True, text=True,
                       cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    return float(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    cases = eight_rank_cases()
    tmp = tmp_path_factory.mktemp("gnn8")
    out = run_on_mesh(gnn_cases, 8, str(tmp / "rendezvous"),
                      args=(cases,), timeout_s=600)
    return cases, out, tmp


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    cases = four_rank_cases()
    tmp = tmp_path_factory.mktemp("gnn4")
    out = run_on_mesh(gnn_cases, 4, str(tmp / "rendezvous"),
                      args=(cases,), timeout_s=600)
    return cases, out


def _result(fixture, name):
    cases, out = fixture[0], fixture[1]
    i = [c["name"] for c in cases].index(name)
    assert all(o[i]["loss"] == out[0][i]["loss"] for o in out), name
    return cases[i], out[0][i]


@pytest.mark.parametrize("name", [c["name"] for c in eight_rank_cases()])
def test_eight_ranks_match_plain_reference(eight, name):
    hold(*_result(eight, name))


def test_graphcast_matches_reference_sharded_loss(eight):
    c, got = _result(eight, "graphcast (4, 2) grid-sharded")
    want = reference_sharded_graphcast(eight[2], c["params"])
    assert got["loss"] == pytest.approx(want, rel=1e-5)


def test_step_with_own_cut_matches_meshless_step(eight):
    c, got = _result(eight, "gatedgcn (2, 2, 2)")
    cfg = gnn.GNNConfig(**c["cfg"])
    params = tree_from_numpy(c["params"], device="cpu")
    step = make_train_step(partial(gnn.train_loss, cfg), AdamWConfig(**OPT))
    p, _, m = step(params, adamw_init(params), to_torch(c["batch"], "cpu"))
    leaves, gnorm = got["stepped"]
    assert gnorm == pytest.approx(float(m["grad_norm"]), rel=1e-5)
    for a, b in zip(leaves, pytree.leaves(p), strict=True):
        b = b.numpy()
        assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b)


@pytest.mark.parametrize("name", [c["name"] for c in four_rank_cases()])
def test_four_ranks_match_plain_reference(four, name):
    hold(*_result(four, name))


class _Mesh:
    """A mesh's shape and one rank's coordinates (no process group)."""

    def __init__(self, dims: dict, coords: dict):
        self.axis_names, self.shape, self.coords = tuple(dims), dims, coords

    def coord(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx


@pytest.mark.parametrize("kind", ["gatedgcn", "graphcast"])
def test_batch_cut_reassembles(kind):
    """Every rank's piece of ``(pod=2, data=2, model=2)``: edge slices
    (graphcast: grid rows and their edges, ids made local) that put back
    together in data order give the full batch; model ranks hold the
    same piece."""
    cfg = gnn.GNNConfig(name="t", kind=kind, n_layers=2, d_hidden=8)
    batch = graph_batch(0) if kind == "gatedgcn" else graphcast_batch()[1]
    dims = dict(pod=2, data=2, model=2)
    pieces = {}
    for pod in range(2):
        for data in range(2):
            for model in range(2):
                coords = dict(pod=pod, data=data, model=model)
                pieces[(pod, data, model)] = local_batch(
                    cfg, batch, _Mesh(dims, coords))
    order = [pieces[(p, d, 0)] for p in range(2) for d in range(2)]
    for k in order[0]:
        assert all(np.array_equal(pieces[(p, d, 0)][k],
                                  pieces[(p, d, 1)][k])
                   for p in range(2) for d in range(2)), k
    nl = NG // 4
    for k, v in batch.items():
        parts = [o[k] for o in order]
        if kind == "graphcast" and k in ("g2m_senders", "m2g_receivers"):
            assert all((x >= 0).all() and (x < nl).all() for x in parts)
            parts = [x + i * nl for i, x in enumerate(parts)]
        whole = (np.concatenate(parts) if parts[0] is not v else v)
        assert np.array_equal(whole, v), k

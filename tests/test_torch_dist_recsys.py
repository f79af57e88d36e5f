"""DCN-v2 on a model mesh (the table sharded by rows over ``"model"``,
looked up through the EmbeddingBag wrapper on each rank's rows) against
the reference, on four CPU ranks over gloo (one spawn).

For the dcn-v2 smoke config (8,192 table rows) on ``(data=2, model=2)``
and ``(data=1, model=4)``, with and without ZeRO, f32 and bf16 compute:

* ``train_loss`` and every gradient leaf (summed over the data axes,
  ZeRO-scattered where it shards the moments, gathered) against
  ``jax.value_and_grad`` of the reference's loss: f32 within 1e-5, bf16
  within 5e-2 (relative L2 per leaf);
* ``forward`` (each data rank its rows, gathered) and ``serve_retrieval``
  against the reference's on the full table (bf16, 5e-2);
* bags of one id: the mesh's sparse features, logits and retrieval
  scores are bit-equal to one process on the same rows and weights;
* foreign ids never reach a shard's rows: the batch holds an id at the
  first row of every shard and none at any shard's last row, and every
  rank's table gradient is zero outside the rows the batch names (the
  kernel clamps an id past its rows to its last row, so an id of
  another shard passed through would write there);
* every lookup is one EmbeddingBag call (``embedding_bag`` on CPU
  tensors: its plain version, no launch counted);
* ``init_recsys(..., mesh=)`` (the launcher's) keeps the meshless
  draws' rows.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke
from repro.models import recsys as jr
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import run_on_mesh
from repro_torch.models.convert import numpy_recsys_params
from torch_dist_workers import recsys_cases

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
CASES = [((2, 2), False, "float32"), ((2, 2), True, "float32"),
         ((1, 4), False, "float32"), ((1, 4), True, "bfloat16"),
         ((2, 2), False, "bfloat16")]
B = 16


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def batches(cfg) -> tuple[dict, dict, dict]:
    """A training batch with an id at the first row of every shard of 2
    and 4 model ranks and none at a shard's last row, a serve batch and
    a retrieval query (bags of one id, a few padded)."""
    r = np.random.default_rng(7)
    sizes = np.array(cfg.table_sizes)
    sparse = r.integers(0, sizes, (B, cfg.n_sparse))
    off = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    quarter = cfg.v_total // 4
    for i, first in enumerate((quarter, 2 * quarter, 3 * quarter)):
        f = int(np.searchsorted(off, first, side="right") - 1)
        last = int(np.searchsorted(off, first - 1, side="right") - 1)
        sparse[:, last] = np.minimum(sparse[:, last], first - 2 - off[last])
        sparse[i, f] = first - off[f]
    sparse[3, 5] = sparse[4, 11] = -1
    train = dict(dense=r.standard_normal((B, cfg.n_dense)).astype(np.float32),
                 sparse=sparse.astype(np.int32),
                 label=r.integers(0, 2, B).astype(np.float32))
    serve = dict(dense=r.standard_normal((B, cfg.n_dense)).astype(np.float32),
                 sparse=r.integers(0, sizes, (B, cfg.n_sparse)).astype(
                     np.int32))
    serve["sparse"][2, 3] = -1
    cand = np.concatenate([r.integers(0, cfg.v_total, 60),
                           [quarter - 1, quarter, cfg.v_total - 1, 0]])
    retrieval = dict(dense=serve["dense"][:1], sparse=serve["sparse"][:1],
                     cand_ids=cand.astype(np.int32))
    return train, serve, retrieval


def _f32_train_loss(jcfg, params, batch):
    """The reference's ``train_loss`` with its forward in f32."""
    logits = jr.forward(jcfg, params, batch, jnp.float32)
    y = batch["label"].astype(jnp.float32)
    return jnp.mean(jnp.maximum(logits, 0) - logits * y
                    + jnp.log1p(jnp.exp(-jnp.abs(logits))))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cfg = get_smoke_config("dcn-v2")
    params = numpy_recsys_params(cfg, 0)
    train, serve, retrieval = batches(cfg)
    cases = [dict(dims=d, zero=z, dtype=t, params=params, batch=train,
                  serve=serve, retrieval=retrieval) for d, z, t in CASES]
    out = run_on_mesh(recsys_cases, 4,
                      str(tmp_path_factory.mktemp("recsys") / "rdv"),
                      args=(cases,), timeout_s=600)
    return params, train, serve, retrieval, out


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{d}-zero={z}-{t}" for d, z, t in CASES])
def test_loss_and_grads_match_reference(run, i):
    params, train, _, _, out = run
    dims, zero, dtype = CASES[i]
    jcfg = jax_smoke("dcn-v2")
    loss_of = _f32_train_loss if dtype == "float32" else jr.train_loss
    wl, wg = jax.jit(jax.value_and_grad(
        lambda p, b: loss_of(jcfg, p, b)))(_jax(params), _jax(train))
    got = out[0][i]
    tol = TOL[dtype]
    assert got["loss"] == pytest.approx(float(wl), rel=tol)
    want = jax.tree.leaves(wg)
    assert len(got["grads"]) == len(want)
    errs = [rel_l2(a, b) for a, b in zip(got["grads"], want)]
    assert max(errs) <= tol, errs


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{d}-zero={z}-{t}" for d, z, t in CASES])
def test_serving_matches_reference_and_one_process(run, i):
    params, _, serve, retrieval, out = run
    jcfg = jax_smoke("dcn-v2")
    want = np.asarray(jr.forward(jcfg, _jax(params), _jax(serve)),
                      np.float32)
    got = out[0][i]
    np.testing.assert_allclose(got["logits"], want, rtol=5e-2,
                               atol=5e-2 * np.abs(want).max())
    want = np.asarray(jr.serve_retrieval(jcfg, _jax(params),
                                         _jax(retrieval)))
    np.testing.assert_allclose(got["scores"], want, rtol=5e-2,
                               atol=5e-2 * np.abs(want).max())
    for rank in out:
        r = rank[i]
        assert r["feats_equal"] and r["logits_equal"] and r["scores_equal"]
        assert r["init_equal"]


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{d}-zero={z}-{t}" for d, z, t in CASES])
def test_foreign_ids_leave_every_shard_alone(run, i):
    _, _, _, _, out = run
    cfg = get_smoke_config("dcn-v2")
    model = CASES[i][0][1]
    for rank in out:
        r = rank[i]
        assert r["local_rows"] == cfg.v_total // model
        assert r["untouched"]
        # on the CPU the wrapper takes its plain version: nothing counted
        assert r["launches"] == 0

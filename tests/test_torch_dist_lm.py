"""LM training on a model mesh against the reference: a dense smoke
config (granite-8b).

Four CPU ranks over gloo (one spawn, ``run_on_mesh``) compute
``transformer.train_loss(..., mesh=)`` and its gradient, each on its
pieces of the tree (``lm_param_shardings``) and its share of the batch;
every gradient leaf is summed over the data axes and gathered in full.
The parent holds the loss and every leaf against ``jax.value_and_grad``
of the reference's loss on the same numpy tree and batch (4 sequences of
16 tokens): f32 within 1e-5 in relative L2 per leaf, bf16 within 5e-2,
on ``(data=2, model=2)`` with sequence parallelism, ``(data=4,
model=1)``, ``(data=1, model=4)`` (granite-8b smoke's 2 kv heads of 16
columns split over 4 ranks: the k / v outputs are gathered), and
``(data=1, model=4)`` with sequence parallelism.  The MoE config is
``test_torch_dist_moe.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import run_on_mesh
from repro_torch.models.convert import numpy_params
from repro_torch.testing import lm_batch
from test_torch_lm_train_dense import DTYPES, jax_loss, rel_l2
from torch_dist_workers import lm_grads

ARCH = "granite-8b"
# (dims, sp, dtype)
CASES = [((2, 2), True, "float32"), ((4, 1), False, "float32"),
         ((1, 4), False, "float32"), ((1, 4), True, "float32"),
         ((2, 2), True, "bfloat16")]


def reference(jcfg, dtype, params, batch, record=None):
    """The reference's loss and gradient leaves (jax's order)."""
    _, jdt, _ = DTYPES[dtype]
    jl, jg = jax.jit(jax.value_and_grad(jax_loss(jcfg, jdt)))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch))
    return float(jl), [np.asarray(g, np.float32) for g in jax.tree.leaves(jg)]


def hold(case, got, want):
    tol = DTYPES[case["dtype"]][2]
    loss, grads = want
    assert got["loss"] == pytest.approx(loss, rel=tol), case["dims"]
    errs = [rel_l2(a, b) for a, b in zip(got["grads"], grads, strict=True)]
    assert max(errs) <= tol, (case["dims"], case["sp"], errs)


def test_dense_loss_and_grads_on_meshes_match_reference(tmp_path):
    cfg = get_smoke_config(ARCH)
    params = numpy_params(cfg, seed=0)
    batch = lm_batch(cfg, np.random.default_rng(1), B=4)
    cases = [dict(arch=ARCH, dims=dims, sp=sp, dtype=dtype, params=params,
                  batch=batch) for dims, sp, dtype in CASES]
    out = run_on_mesh(lm_grads, 4, str(tmp_path / "rendezvous"),
                      args=(cases,), timeout_s=600)
    want = {dtype: reference(jax_smoke(ARCH), dtype, params, batch)
            for dtype in DTYPES}
    for i, case in enumerate(cases):
        assert all(o[i]["loss"] == out[0][i]["loss"] for o in out)
        hold(case, out[0][i], want[case["dtype"]])

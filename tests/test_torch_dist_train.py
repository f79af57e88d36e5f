"""Training steps on a model mesh, on four CPU ranks over gloo.

* Three ``make_train_step`` steps (AdamW, accumulation over two
  microbatches) with ZeRO and sequence parallelism on ``(data=2,
  model=2)``, granite-moe smoke in f32: each step's loss and gradient
  norm, then every parameter and moment leaf (gathered), against the
  reference's jitted step within 1e-5, and against the port's meshless
  step within 1e-6 (the moments within 1e-5: they sum gradients the
  ranks add in another order, f32 noise of ~1e-6, as large as the
  meshless step's own distance from the reference).  A rank holds its
  slice of each moment along the ZeRO dimension and the model axis.

The launcher and checkpoints across mesh shapes are
``test_torch_dist_launch.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from functools import partial

from repro.configs import get_smoke_config as jax_smoke
from repro.train import optimizer as jo
from repro.train import steps as js
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import run_on_mesh
from repro_torch.models import transformer as tt
from repro_torch.models.convert import numpy_params, tree_from_numpy
from repro_torch.testing import lm_batch
from repro_torch.train import pytree
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.steps import make_train_step
from test_torch_lm_train_dense import OPT, jax_loss, rel_l2
from torch_dist_workers import lm_steps

ARCH = "granite-moe-3b-a800m"


def test_three_zero_steps_match_reference_and_meshless(tmp_path):
    cfg = get_smoke_config(ARCH)
    params = numpy_params(cfg, seed=4)
    r = np.random.default_rng(10)
    batches = [lm_batch(cfg, r, B=4) for _ in range(3)]
    case = dict(arch=ARCH, dims=(2, 2), sp=True, zero=True, accum=2,
                opt=OPT, params=params, batches=batches)
    out = run_on_mesh(lm_steps, 4, str(tmp_path / "rendezvous"),
                      args=(case,), timeout_s=600)
    got = out[0]
    # reference: the jitted step
    jstep = jax.jit(js.make_train_step(jax_loss(jax_smoke(ARCH),
                                                jnp.float32),
                                       jo.AdamWConfig(**OPT),
                                       accum_steps=2))
    jp = jax.tree.map(jnp.asarray, params)
    jst = jo.adamw_init(jp)
    # the port's meshless step
    tp = tree_from_numpy(params, device="cpu")
    tst = adamw_init(tp)
    step = make_train_step(partial(tt.train_loss, cfg,
                                   compute_dtype=torch.float32),
                           AdamWConfig(**OPT), accum_steps=2)
    for b, (loss, gnorm) in zip(batches, got["metrics"], strict=True):
        jp, jst, jm = jstep(jp, jst, jax.tree.map(jnp.asarray, b))
        tp, tst, tm = step(tp, tst, {k: torch.as_tensor(v)
                                     for k, v in b.items()})
        for mine, ref, tol in ((loss, jm["loss"], 1e-5),
                               (gnorm, jm["grad_norm"], 1e-5),
                               (loss, tm["loss"], 1e-6),
                               (gnorm, tm["grad_norm"], 1e-6)):
            assert mine == pytest.approx(float(ref), rel=tol)
    ref = jax.tree.leaves(dict(params=jp, opt=jst))
    meshless = pytree.flatten_with_paths(dict(params=tp, opt=tst))
    assert len(got["leaves"]) == len(ref) == len(meshless)
    for a, b, (path, c) in zip(got["leaves"], ref, meshless):
        assert rel_l2(a, b) <= 1e-5, path
        # the moments are sums of gradients, which the ranks add in
        # another order: f32 noise of ~1e-6 (the meshless step is up to
        # 1.7e-6 from the reference there), held to the reference's 1e-5
        tol = 1e-5 if path.startswith("['opt']") else 1e-6
        assert rel_l2(a, c.numpy()) <= tol, path
    # mu['embed'] [128, 48]: vocab over model, ZeRO on dim 1 over data
    assert all(o["local_moment"] == (64, 24) for o in out)

"""LM training on a model mesh against the reference: the MoE smoke
config (granite-moe-3b-a800m: 8 experts, top-2), experts sharded over
``"model"``.

As ``test_torch_dist_lm.py`` (four CPU ranks over gloo, one spawn; the
loss and every gathered gradient leaf against ``jax.value_and_grad`` of
the reference's loss, f32 within 1e-5, bf16 within 5e-2), on ``(data=2,
model=2)`` with sequence parallelism, ``(data=4, model=1)`` and
``(data=1, model=4)``, and at ``capacity_factor=1.0`` on ``(data=2,
model=2)``, where tokens are dropped: the capacity, each token's slot
(its place in the global token order) and the Switch aux are global
over the data ranks, so the loss and gradients are the reference's only
if all three are.  Every model rank of a data rank routes alike.  In
bf16 the reference's expert choices are recorded (remat off on both
sides, so each layer routes once) and handed to the ranks, each taking
its rows, as ``test_torch_lm_train_moe.py`` pins them.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke
from repro.models import moe as jm
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import run_on_mesh
from repro_torch.models.convert import numpy_params
from repro_torch.models.moe import capacity
from repro_torch.testing import lm_batch
from test_torch_dist_lm import hold, reference
from torch_dist_workers import lm_grads

ARCH = "granite-moe-3b-a800m"
# (dims, sp, dtype, config changes)
CASES = [((2, 2), True, "float32", {}), ((4, 1), False, "float32", {}),
         ((1, 4), False, "float32", {}),
         ((2, 2), True, "float32", dict(capacity_factor=1.0)),
         ((2, 2), True, "bfloat16", dict(remat=False))]


def recorded_reference(jcfg, dtype, params, batch, monkeypatch):
    """``reference`` with the reference's experts of every ``route`` call
    recorded (a ``jax.debug.callback``)."""
    calls = []
    own = jm.route

    def record(cfg, h2, w):
        gates, experts, aux = own(cfg, h2, w)
        jax.debug.callback(lambda e: calls.append(np.array(e)), experts,
                           ordered=True)
        return gates, experts, aux
    with monkeypatch.context() as m:
        m.setattr(jm, "route", record)
        want = reference(jcfg, dtype, params, batch)
    return want, calls


def test_moe_loss_and_grads_on_meshes_match_reference(tmp_path,
                                                      monkeypatch):
    cfg = get_smoke_config(ARCH)
    params = numpy_params(cfg, seed=0)
    batch = lm_batch(cfg, np.random.default_rng(1), B=4)
    cases, wants = [], []
    for dims, sp, dtype, change in CASES:
        jcfg = dataclasses.replace(jax_smoke(ARCH), **change)
        want, calls = recorded_reference(jcfg, dtype, params, batch,
                                         monkeypatch)
        assert len(calls) == cfg.n_layers * (1 if not jcfg.remat else 2)
        cases.append(dict(arch=ARCH, dims=dims, sp=sp, dtype=dtype,
                          params=params, batch=batch, replace=change,
                          pinned=calls if dtype == "bfloat16" else None))
        wants.append((want, calls))
    out = run_on_mesh(lm_grads, 4, str(tmp_path / "rendezvous"),
                      args=(cases,), timeout_s=600)
    for i, (case, (want, calls)) in enumerate(zip(cases, wants)):
        hold(case, out[0][i], want)
        if case["pinned"] is not None:
            continue
        # every model rank of a data rank took the same routes, each
        # data rank its rows of the reference's (f32: no near tie here)
        by_data = {}
        for o in out:
            c = o[i]["coords"]
            by_data.setdefault(c["data"], []).append(o[i]["routes"])
        for d, ranks in by_data.items():
            for routes in ranks[1:]:
                assert all(np.array_equal(a, b)
                           for a, b in zip(ranks[0], routes, strict=True))
            T = len(ranks[0][0])
            for mine, ref in zip(ranks[0], calls[:cfg.n_layers]):
                assert np.array_equal(np.sort(mine, -1), np.sort(
                    ref[d * T:(d + 1) * T], -1))
    # capacity_factor 1.0 drops tokens: some expert is over its global
    # capacity in some layer (and each data rank alone would fit more)
    change = CASES[3][3]
    C = capacity(dataclasses.replace(cfg, **change), 4 * 16)
    counts = [np.bincount(e.reshape(-1), minlength=cfg.e_pad)
              for e in wants[3][1]]
    assert max(int(c.max()) for c in counts) > C


@pytest.mark.parametrize("n_data", [2, 4])
@pytest.mark.parametrize("half", [0, 1])
def test_rank_tables_are_windows_of_the_global_table(n_data, half):
    """A data rank's slot table (``dispatch_tables`` with the prefix of
    the ranks before it, its model rank's half of the experts and the
    width of its fullest expert's window, as ``moe_mlp`` builds it) is
    its window of the one-process table of all ranks' tokens: row ``j``
    of expert ``e`` is global slot ``prefix[e] + j``, and the rows past
    the rank's kept tokens are empty (capacity factor 1.0: tokens are
    dropped)."""
    import torch
    from repro_torch.models.moe import dispatch_tables
    cfg = dataclasses.replace(get_smoke_config(ARCH), capacity_factor=1.0)
    T, k, E = 24, cfg.top_k, cfg.e_pad
    rng = np.random.default_rng(n_data + 10 * half)
    skew = np.linspace(1.0, 3.0, cfg.n_experts)      # the last ones full
    experts = torch.as_tensor((rng.random((n_data * T, cfg.n_experts))
                               * skew).argsort(-1)[:, -k:].copy())
    C = capacity(cfg, n_data * T)
    glob_tok, glob_pos = dispatch_tables(cfg, experts, C)
    lo, hi = half * E // 2, (half + 1) * E // 2
    counts = [torch.bincount(experts[r * T:(r + 1) * T].reshape(-1),
                             minlength=E) for r in range(n_data)]
    kept_all = 0
    for r in range(n_data):
        prefix = sum(counts[:r], torch.zeros(E, dtype=torch.int64))
        kept = torch.minimum(counts[r], (C - prefix).clamp(min=0))
        width = max(8, -(-int(kept[lo:hi].max()) // 8) * 8)
        tok, pos = dispatch_tables(cfg, experts[r * T:(r + 1) * T], C,
                                   prefix, lo, hi, width)
        assert tok.shape == (hi - lo, width) and width <= C
        for e in range(lo, hi):
            n, p0 = int(kept[e]), int(prefix[e])
            row = tok[e - lo]
            assert torch.equal(row[:n] + r * T, glob_tok[e, p0:p0 + n])
            assert torch.equal(pos[e - lo, :n] + r * T * k,
                               glob_pos[e, p0:p0 + n])
            assert bool((row[n:] == -1).all())
            kept_all += n
    assert kept_all == int((glob_tok[lo:hi] >= 0).sum())
    assert int((glob_tok >= 0).sum()) < experts.numel()    # some dropped

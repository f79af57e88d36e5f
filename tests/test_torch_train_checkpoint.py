"""The port's checkpoints and fault tolerance against ``repro.train``.

* The checkpoint format is shared: the same tree saved by both packages
  gives equal manifests (paths, files, shapes, dtypes, step, extra,
  ``done``) and byte-equal ``.npy`` files, and a checkpoint written by
  either package restores in the other (an AdamW state included).
* The reference's cases of ``tests/test_train.py:91-256`` run on the
  port: round trip and ``latest_step``, shape mismatch, an incomplete
  write ignored, ``run_resumable`` resume / retry / skip, the retry
  classification (the port's taxonomy gives the reference's kind for
  every exception of the battery, and the card's out-of-memory error is
  retryable), and the ``WorkQueue`` cases.
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jckpt
from repro.train import optimizer as jo
from repro.train.fault_tolerance import run_resumable as j_run_resumable
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import pytree
from repro_torch.train.fault_tolerance import (WorkQueue,
                                               run_estimation_distributed,
                                               run_resumable)
from repro_torch.train.optimizer import AdamState, adamw_init


def _numpy_state(seed=0):
    r = np.random.default_rng(seed)
    params = dict(layers=[dict(W=r.standard_normal((3, 4)).astype(np.float32),
                               b=r.standard_normal(4).astype(np.float32))
                          for _ in range(2)],
                  table=r.standard_normal((5, 2)).astype(np.float32))
    mu = jax.tree.map(lambda a: (0.1 * a).astype(np.float32), params)
    nu = jax.tree.map(lambda a: (a * a).astype(np.float32), params)
    return params, np.int32(7), mu, nu


def _jax_tree(seed=0):
    params, step, mu, nu = _numpy_state(seed)
    return dict(params=jax.tree.map(jnp.asarray, params),
                opt=jo.AdamState(step=jnp.asarray(step), mu=jax.tree.map(
                    jnp.asarray, mu), nu=jax.tree.map(jnp.asarray, nu)))


def _torch_tree(seed=0):
    params, step, mu, nu = _numpy_state(seed)

    def t(tree):
        return pytree.tree_map(lambda a: torch.tensor(np.array(a)), tree)
    return dict(params=t(params),
                opt=AdamState(step=torch.tensor(step), mu=t(mu), nu=t(nu)))


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_manifests_and_files_equal_across_packages(tmp_path):
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.save(a, 3, _jax_tree(), extra=dict(next_step=3, note="x"))
    ckpt.save(b, 3, _torch_tree(), extra=dict(next_step=3, note="x"))
    man = _manifest(b, 3)
    assert man == _manifest(a, 3)
    assert man["leaves"][0]["path"] == "['opt'].step"
    assert man["leaves"][0]["dtype"] == "int32"
    assert man["leaves"][1]["path"] == "['opt'].mu['layers'][0]['W']"
    assert [e["path"] for e in man["leaves"]][-2:] == [
        "['params']['layers'][1]['b']", "['params']['table']"]
    for e in man["leaves"]:
        with open(os.path.join(a, "step_00000003", e["file"]), "rb") as f:
            want = f.read()
        with open(os.path.join(b, "step_00000003", e["file"]), "rb") as f:
            assert f.read() == want, e["path"]


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    d = str(tmp_path)
    jckpt.save(d, 5, _jax_tree(1), extra=dict(next_step=5))
    assert ckpt.latest_step(d) == 5
    like = _torch_tree(0)
    got, extra = ckpt.restore(d, 5, like, device="cpu")
    assert extra == dict(next_step=5)
    assert isinstance(got["opt"], AdamState)
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 7
    want = pytree.leaves(_torch_tree(1))
    for g, w in zip(pytree.leaves(got), want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 9, _torch_tree(2), extra=dict(next_step=9))
    assert jckpt.latest_step(d) == 9
    got, extra = jckpt.restore(d, 9, _jax_tree(0))
    assert extra == dict(next_step=9)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(_jax_tree(2))):
        assert g.dtype == w.dtype
        assert np.array_equal(np.asarray(g), np.asarray(w))


def test_restore_places_leaves_and_refuses_bfloat16(tmp_path):
    d = str(tmp_path)
    params = dict(w=torch.ones(3), n=torch.arange(2))
    ckpt.save(d, 1, dict(params=params, opt=adamw_init(params)))
    like = dict(params=dict(w=torch.zeros(3, dtype=torch.float64),
                            n=torch.zeros(2, dtype=torch.int64)),
                opt=adamw_init(params))
    got, _ = ckpt.restore(d, 1, like)
    assert got["params"]["w"].dtype == torch.float64
    assert torch.equal(got["params"]["w"], torch.ones(3, dtype=torch.float64))
    assert got["opt"].mu["n"].shape == ()
    with pytest.raises(ValueError, match="bfloat16"):
        ckpt.save(d, 2, dict(w=torch.ones(2, dtype=torch.bfloat16)))
    with pytest.raises(ValueError, match="path mismatch"):
        ckpt.restore(d, 1, dict(params=dict(v=torch.ones(3),
                                            n=torch.zeros(2)),
                                opt=adamw_init(params)))


# --- the reference's cases (tests/test_train.py:91-256), on the port ---
def test_checkpoint_roundtrip_and_latest(tmp_path):
    tree = dict(a=torch.arange(12, dtype=torch.float32).reshape(3, 4),
                nested=dict(b=torch.ones((2,), dtype=torch.int32)))
    d = str(tmp_path)
    ckpt.save(d, 3, tree, extra=dict(next_step=3))
    ckpt.save(d, 7, pytree.tree_map(lambda x: x * 2, tree),
              extra=dict(next_step=7))
    assert ckpt.latest_step(d) == 7
    restored, extra = ckpt.restore(d, 7, tree)
    assert torch.equal(restored["a"], tree["a"] * 2)
    assert extra["next_step"] == 7
    ckpt.prune(d, keep=1)
    assert ckpt.latest_step(d) == 7
    assert not os.path.exists(os.path.join(d, "step_00000003"))


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, dict(a=torch.ones((3,))))
    with pytest.raises(ValueError):
        ckpt.restore(d, 1, dict(a=torch.ones((4,))))


def test_incomplete_checkpoint_ignored(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 5, dict(a=torch.ones((2,))))
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert ckpt.latest_step(d) == 5


def _add_step(state, batch, step):
    return {"x": state["x"] + batch}, dict(step=step)


def test_run_resumable_resumes_identically(tmp_path):
    """Stop after step 7, rerun to 12: the state equals the unbroken
    run's, and equals the reference driver's on the same schedule."""
    def batches(step, attempt):
        return float(step)
    full, _ = run_resumable(_add_step, {"x": 0.0}, batches, 12,
                            str(tmp_path / "a"), ckpt_every=3)
    d2 = str(tmp_path / "b")
    run_resumable(_add_step, {"x": 0.0}, batches, 7, d2, ckpt_every=3)
    resumed, rep = run_resumable(_add_step, {"x": 0.0}, batches, 12, d2,
                                 ckpt_every=3)
    assert rep.resumed_from == 7
    assert float(resumed["x"]) == float(full["x"]) == 66.0
    ref, _ = j_run_resumable(_add_step, {"x": 0.0}, batches, 12,
                             str(tmp_path / "c"), ckpt_every=3)
    assert float(ref["x"]) == float(full["x"])


def test_run_resumable_resumes_from_a_reference_checkpoint(tmp_path):
    """The reference's driver stops after step 5; the port's resumes from
    its checkpoint to step 9."""
    d = str(tmp_path)
    j_run_resumable(_add_step, {"x": 0.0}, lambda s, a: float(s), 5, d,
                    ckpt_every=2)
    got, rep = run_resumable(_add_step, {"x": 0.0}, lambda s, a: float(s),
                             9, d, ckpt_every=2)
    assert rep.resumed_from == 5 and rep.steps_run == 4
    assert float(got["x"]) == 36.0


def test_run_resumable_retries_then_skips(tmp_path):
    calls = []

    def injector(step, attempt):
        calls.append((step, attempt))
        if step == 2:
            raise TimeoutError("flaky link")

    state, rep = run_resumable(lambda s, b, i: (s, {}), {"x": 0.0},
                               lambda s, a: 0.0, 4, str(tmp_path),
                               ckpt_every=100, max_retries=2,
                               fail_injector=injector)
    assert rep.retries == 3
    assert rep.failures_skipped == 1
    assert rep.steps_run == 4


def test_run_resumable_fatal_skips_without_retrying(tmp_path):
    attempts = []

    def injector(step, attempt):
        attempts.append((step, attempt))
        if step == 1:
            raise RuntimeError("logic bug")

    state, rep = run_resumable(lambda s, b, i: (s, {}), {"x": 0.0},
                               lambda s, a: 0.0, 3, str(tmp_path),
                               ckpt_every=100, max_retries=2,
                               fail_injector=injector)
    assert rep.retries == 0
    assert rep.failures_skipped == 1
    assert rep.steps_run == 3
    assert (1, 1) not in attempts


class OutOfMemoryError(RuntimeError):
    """Stands in for ``torch.cuda.OutOfMemoryError`` (matched by name)."""


def test_transient_classification_parity_across_layers(tmp_path):
    """The port's training driver and work queue retry exactly what the
    port's taxonomy calls retryable, which is the reference's kind for
    every exception of the reference's battery; the card's OOM is
    retryable."""
    from repro.resilience import classify as ref_classify
    from repro_torch.resilience import (BadRequestError, FatalError,
                                        TransientError, classify,
                                        is_retryable)
    from repro.resilience import (BadRequestError as RefBadRequest,
                                  FatalError as RefFatal,
                                  TransientError as RefTransient)
    battery = [
        (TimeoutError("t"), TimeoutError("t"), "retryable"),
        (ConnectionError("c"), ConnectionError("c"), "retryable"),
        (MemoryError("m"), MemoryError("m"), "retryable"),
        (TransientError("marked"), RefTransient("marked"), "retryable"),
        (RuntimeError("bug"), RuntimeError("bug"), "fatal"),
        (FatalError("hard"), RefFatal("hard"), "fatal"),
        (AssertionError("a"), AssertionError("a"), "fatal"),
        (ValueError("v"), ValueError("v"), "bad_request"),
        (BadRequestError("b"), RefBadRequest("b"), "bad_request"),
        (OutOfMemoryError("CUDA out of memory"), None, "retryable"),
    ]
    for exc, ref_exc, kind in battery:
        assert classify(exc) == kind, exc
        if ref_exc is not None:
            assert ref_classify(ref_exc) == kind, ref_exc

        def injector(step, attempt, _exc=exc):
            if step == 0:
                raise _exc
        d = str(tmp_path / f"{type(exc).__name__}_{kind}")
        _, rep = run_resumable(lambda s, b, i: (s, {}), {}, lambda s, a: 0,
                               1, d, max_retries=2, fail_injector=injector)
        assert rep.failures_skipped == 1
        assert (rep.retries > 0) == is_retryable(exc), exc

        q = WorkQueue(1, lease_s=100.0)
        assert q.acquire(0) == 0
        assert q.fail(0, exc) == kind
        if is_retryable(exc):
            assert q.acquire(1) == 0
        else:
            assert q.acquire(1) is None
            assert not q.all_done or q.units[0].fatal
            with pytest.raises(RuntimeError, match="fatally"):
                q.results()


def test_workqueue_fail_after_completion_is_noop():
    q = WorkQueue(1, lease_s=100.0)
    q.acquire(0)
    q.complete(0, 42)
    q.fail(0, TimeoutError("late straggler error"))
    assert q.results() == [42]


def test_workqueue_straggler_reissue():
    results, q = run_estimation_distributed(
        worker_fn=lambda uid: uid * 10, n_units=12, n_workers=3,
        straggler_of=lambda w: w == 0)
    assert results == [u * 10 for u in range(12)]
    assert q.reissues >= 1


def test_workqueue_duplicate_completion_idempotent():
    q = WorkQueue(3, lease_s=100.0)
    assert q.acquire(0) == 0
    assert q.complete(0, "a") is True
    assert q.complete(0, "b") is False
    q.complete(1, "x")
    q.complete(2, "y")
    assert q.results() == ["a", "x", "y"]

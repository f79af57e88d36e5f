"""The port's training launcher (``repro_torch.launch.train``) on the CPU.

``--device cpu --scale smoke --arch dcn-v2`` trains, checkpoints in the
reference's layout and resumes: a 6-step run that lost everything after
its step-4 checkpoint (the later checkpoint deleted) and is run again
ends with the parameters of the unbroken run, bit for bit (one process,
the same CPU kernels); the manifest lists the reference's paths.  A
fault raised inside the optimizer, after it has updated a leaf, leaves
the step's state intact: the run retries (or skips) exactly as it does
when the same fault is raised before the step, killed and resumed or
not.  A GNN arch exits with the reference's message, and without a card
the default device raises before anything is written.  The LM archs are
in ``test_torch_launch_train_lm.py``.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch.train import GNN_EXIT, build, main, synthetic_batch
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer, pytree
from repro_torch.train.fault_tolerance import run_resumable


def _run(tmp, steps, capsys, every=2):
    main(["--device", "cpu", "--scale", "smoke", "--arch", "dcn-v2",
          "--steps", str(steps), "--ckpt-dir", str(tmp), "--ckpt-every",
          str(every)])
    return capsys.readouterr().out.strip().splitlines()[-1]


def _leaves(d):
    step = ckpt.latest_step(str(d))
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        man = json.load(f)
    return step, man, [np.load(os.path.join(d, f"step_{step:08d}",
                                            e["file"]))
                       for e in man["leaves"]]


def test_dcn_v2_smoke_trains_and_resumes(tmp_path, capsys):
    line = _run(tmp_path / "straight", 6, capsys)
    assert line.startswith("ran 6 steps (resumed_from=None, retries=0)")
    first = _run(tmp_path / "broken", 6, capsys)
    assert first == line
    shutil.rmtree(tmp_path / "broken" / "step_00000006")   # the crash
    assert ckpt.latest_step(str(tmp_path / "broken")) == 4
    second = _run(tmp_path / "broken", 6, capsys)
    assert second.startswith("ran 2 steps (resumed_from=4, retries=0)")
    s1, man1, a = _leaves(tmp_path / "straight")
    s2, man2, b = _leaves(tmp_path / "broken")
    assert s1 == s2 == 6 and man1 == man2
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    paths = [e["path"] for e in man1["leaves"]]
    assert paths[0] == "['opt'].step"
    assert "['params']['table']" in paths
    assert "['opt'].mu['cross'][0]['W']" in paths
    losses = [float(t) for t in line.split("loss ")[1].split(" -> ")]
    assert all(np.isfinite(losses))


@pytest.mark.parametrize("fault, retries, skipped", [
    (torch.cuda.OutOfMemoryError("out of memory at the second leaf"), 1, 0),
    (ValueError("poisoned update"), 0, 1)])
def test_fault_inside_the_optimizer_leaves_the_state_intact(
        tmp_path, monkeypatch, fault, retries, skipped):
    """Step 1's first attempt raises from the optimizer's second leaf,
    after its first leaf is updated.  A retryable fault is retried with
    attempt 1's batch, any other skips the step; either way the run,
    killed after step 2 and resumed to step 4, ends equal to the run
    where the same fault is raised before the step."""
    cfg = get_smoke_config("dcn-v2")

    def batches(step, attempt):
        return synthetic_batch(cfg, 4, 0, step * 1000 + attempt, "cpu")

    def before_step(step, attempt):
        if (step, attempt) == (1, 0):
            raise fault
    want, rep_want = run_resumable(
        build(cfg, 1e-3, 4, device="cpu")[1],
        build(cfg, 1e-3, 4, device="cpu")[0], batches, 4,
        str(tmp_path / "before"), ckpt_every=1, fail_injector=before_step)
    assert (rep_want.retries, rep_want.failures_skipped) == (retries,
                                                             skipped)
    leaf = optimizer._adamw_leaf
    n_leaves = len(pytree.leaves(build(cfg, 1e-3, 4, device="cpu")[0]
                                 ["params"]))
    calls = []

    def faulty_leaf(*args):
        calls.append(1)
        if len(calls) == n_leaves + 2:      # step 1, attempt 0, leaf 1
            raise fault
        return leaf(*args)
    monkeypatch.setattr(optimizer, "_adamw_leaf", faulty_leaf)
    for total in (2, 4):
        state, do_step = build(cfg, 1e-3, 4, device="cpu")
        got, rep = run_resumable(do_step, state, batches, total,
                                 str(tmp_path / "inside"), ckpt_every=1)
        if total == 2:
            assert (rep.retries, rep.failures_skipped) == (retries, skipped)
    assert rep.resumed_from == 2 and len(calls) > 3 * n_leaves
    a, b = pytree.leaves(want), pytree.leaves(got)
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_gnn_arch_exits_with_the_reference_message(tmp_path):
    with pytest.raises(SystemExit) as e:
        main(["--device", "cpu", "--arch", "gat-cora", "--ckpt-dir",
              str(tmp_path)])
    assert str(e.value) == GNN_EXIT == (
        "use examples/motif_features_gnn.py for GNN archs")


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "dcn-v2", "--ckpt-dir", str(tmp_path / "x")])
    assert not (tmp_path / "x").exists()

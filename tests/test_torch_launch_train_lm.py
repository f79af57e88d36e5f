"""The port's training launcher on the LM archs, on the CPU.

* ``synthetic_batch``'s LM branch is the reference's: the same tokens,
  labels and mask, dtypes included;
* ``main(["--arch", <LM>, "--scale", "smoke", "--device", "cpu", ...])``
  trains each of the five LM configs (finite losses, the reference's
  checkpoint paths);
* a granite-moe smoke run that lost everything after its step-2
  checkpoint and is run again ends with the unbroken run's state, bit
  for bit;
* an LM-tree checkpoint written by either package restores in the other,
  leaf for leaf.
"""
from __future__ import annotations

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.launch.train import synthetic_batch as jax_synthetic_batch
from repro.models import transformer as jt
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jo
from repro_torch.configs import get_smoke_config
from repro_torch.launch.train import build, main, synthetic_batch
from repro_torch.models.convert import numpy_params, tree_from_numpy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import pytree
from repro_torch.train.optimizer import adamw_init

LM_IDS = ("granite-8b", "gemma2-27b", "deepseek-7b", "qwen2-moe-a2.7b",
          "granite-moe-3b-a800m")


def _run(arch, tmp, steps, capsys, every=2):
    main(["--device", "cpu", "--scale", "smoke", "--arch", arch,
          "--steps", str(steps), "--batch", "2", "--seq", "16",
          "--ckpt-dir", str(tmp), "--ckpt-every", str(every)])
    return capsys.readouterr().out.strip().splitlines()[-1]


def _manifest(d):
    step = ckpt.latest_step(str(d))
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return step, json.load(f)


def test_synthetic_batch_is_the_references():
    cfg, jcfg = get_smoke_config("granite-8b"), jax_smoke("granite-8b")
    for step in (0, 2001):
        want = jax_synthetic_batch(jcfg, 3, 16, step)
        got = synthetic_batch(cfg, 3, 16, step, "cpu")
        assert set(got) == set(want) == {"tokens", "labels", "mask"}
        for k in want:
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
            assert np.array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("arch", LM_IDS)
def test_lm_smoke_trains_on_the_cpu(arch, tmp_path, capsys):
    line = _run(arch, tmp_path, 2, capsys)
    assert line.startswith("ran 2 steps (resumed_from=None, retries=0)")
    losses = [float(t) for t in line.split("loss ")[1].split(" -> ")]
    assert all(np.isfinite(losses))
    step, man = _manifest(tmp_path)
    paths = [e["path"] for e in man["leaves"]]
    assert step == 2 and paths[0] == "['opt'].step"
    assert "['params']['layers']['wq']" in paths
    assert "['opt'].mu['embed']" in paths


def test_killed_and_resumed_run_equals_the_straight_run(tmp_path, capsys):
    arch = "granite-moe-3b-a800m"
    line = _run(arch, tmp_path / "straight", 4, capsys)
    assert _run(arch, tmp_path / "broken", 4, capsys) == line
    shutil.rmtree(tmp_path / "broken" / "step_00000004")     # the crash
    second = _run(arch, tmp_path / "broken", 4, capsys)
    assert second.startswith("ran 2 steps (resumed_from=2, retries=0)")
    (s1, m1), (s2, m2) = (_manifest(tmp_path / d)
                          for d in ("straight", "broken"))
    assert s1 == s2 == 4 and m1 == m2
    for e in m1["leaves"]:
        a, b = (np.load(tmp_path / d / "step_00000004" / e["file"])
                for d in ("straight", "broken"))
        assert np.array_equal(a, b), e["path"]


def _states(arch):
    """The same LM training state in both packages: numpy weights from a
    seed, fresh AdamW moments."""
    cfg = get_smoke_config(arch)
    params = numpy_params(cfg, seed=3)
    port = tree_from_numpy(params, device="cpu")
    ref = jax.tree.map(jnp.asarray, params)
    return (dict(params=port, opt=adamw_init(port)),
            dict(params=ref, opt=jo.adamw_init(ref)))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_lm_checkpoints_cross_between_the_packages(writer, tmp_path):
    """gemma2-27b smoke (tied embeddings, post norms): the state written
    by one package restores in the other, every leaf equal."""
    port, ref = _states("gemma2-27b")
    d = str(tmp_path)
    if writer == "port":
        ckpt.save(d, 7, port, extra=dict(next_step=7))
        got, extra = jckpt.restore(d, 7, jax.tree.map(jnp.zeros_like, ref))
        got_leaves = [np.asarray(x) for x in jax.tree.leaves(got)]
    else:
        jckpt.save(d, 7, ref, extra=dict(next_step=7))
        got, extra = ckpt.restore(d, 7, pytree.tree_map(torch.zeros_like,
                                                        port))
        got_leaves = [x.numpy() for x in pytree.leaves(got)]
    assert extra["next_step"] == 7
    want = [x.numpy() for x in pytree.leaves(port)]
    assert len(got_leaves) == len(want) == len(jax.tree.leaves(ref))
    assert all(np.array_equal(a, b) for a, b in zip(got_leaves, want))
    paths = [p for p, _ in pytree.flatten_with_paths(port)]
    assert paths == [jax.tree_util.keystr(p) for p, _ in
                     jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert "['params']['unembed']" not in paths          # tied
    assert jt.abstract_params(jax_smoke("gemma2-27b"))["layers"].keys() == \
        port["params"]["layers"].keys()


def test_build_makes_the_lm_state_of_the_reference_layout():
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    state, do_step = build(cfg, 1e-3, 4, device="cpu")
    want = jt.abstract_params(jax_smoke("qwen2-moe-a2.7b"))
    got = state["params"]
    assert [p for p, _ in pytree.flatten_with_paths(got)] == \
        [jax.tree_util.keystr(p) for p, _ in
         jax.tree_util.tree_flatten_with_path(want)[0]]
    for a, b in zip(pytree.leaves(got), jax.tree.leaves(want)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    batch = synthetic_batch(cfg, 2, 8, 0, "cpu")
    new, metrics = do_step(state, batch, 0)
    assert np.isfinite(metrics["loss"]) and int(new["opt"].step) == 1
    assert int(state["opt"].step) == 0          # the given state is intact

"""The training launcher on a model mesh, and checkpoints across mesh
shapes, on four CPU ranks over gloo.

``launch.train --mesh data=2,model=2 --zero --sp --backend gloo --device
cpu`` (f32 compute) for 3 granite-moe smoke steps: its printed losses
and final checkpoint equal the meshless run's within 1e-5.  Checkpoints
cross mesh shapes: the mesh run's step-2 checkpoint resumed meshless,
and a meshless step-2 checkpoint resumed on the mesh, each end equal to
the straight run (the schedule's length is ``--steps``, so a resumed run
equals the straight one at the same ``--steps``).  The launcher checks
its mesh flags before it starts a process, and ``make_train_step``
refuses gradient compression on sharded leaves.
"""
from __future__ import annotations

import json
import shutil

import numpy as np
import pytest

from repro_torch.launch.train import main
from test_torch_lm_train_dense import rel_l2

ARCH = "granite-moe-3b-a800m"


def _run(tmp, steps, capsys, *mesh):
    main(["--device", "cpu", "--scale", "smoke", "--arch", ARCH,
          "--steps", str(steps), "--ckpt-every", "2", "--compute-dtype",
          "float32", "--ckpt-dir", str(tmp), *mesh])
    return capsys.readouterr().out.strip().splitlines()[-1]


def _final(tmp, step):
    d = tmp / f"step_{step:08d}"
    man = json.loads((d / "manifest.json").read_text())
    return [(e["path"], np.load(d / e["file"])) for e in man["leaves"]]


def _hold_equal(a, b, tol=1e-5):
    assert [p for p, _ in a] == [p for p, _ in b]
    errs = [rel_l2(x, y) for (_, x), (_, y) in zip(a, b)]
    assert max(errs) <= tol, errs


MESH = ("--mesh", "data=2,model=2", "--zero", "--sp", "--backend", "gloo")


def test_launcher_on_a_mesh_and_checkpoints_across_shapes(tmp_path, capsys):
    straight = _run(tmp_path / "straight", 3, capsys)
    on_mesh = _run(tmp_path / "mesh", 3, capsys, *MESH)
    losses = [[float(t) for t in line.split("loss ")[1].split(" -> ")]
              for line in (straight, on_mesh)]
    assert np.allclose(losses[0], losses[1], rtol=1e-5, atol=0)
    want = _final(tmp_path / "straight", 3)
    _hold_equal(_final(tmp_path / "mesh", 3), want)
    assert not list((tmp_path / "mesh").glob("rendezvous*"))
    # the mesh's step-2 checkpoint, resumed meshless
    shutil.rmtree(tmp_path / "mesh" / "step_00000003")
    line = _run(tmp_path / "mesh", 3, capsys)
    assert "resumed_from=2" in line
    _hold_equal(_final(tmp_path / "mesh", 3), want)
    # a meshless step-2 checkpoint, resumed on the mesh
    shutil.copytree(tmp_path / "straight", tmp_path / "cross")
    shutil.rmtree(tmp_path / "cross" / "step_00000003")
    line = _run(tmp_path / "cross", 3, capsys, *MESH)
    assert "resumed_from=2" in line
    _hold_equal(_final(tmp_path / "cross", 3), want)


def test_launcher_mesh_flags_are_checked(tmp_path):
    with pytest.raises(SystemExit, match="--backend"):
        main(["--device", "cpu", "--arch", ARCH, "--mesh",
              "data=2,model=2", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="need --mesh"):
        main(["--device", "cpu", "--arch", ARCH, "--zero", "--ckpt-dir",
              str(tmp_path)])
    with pytest.raises(ValueError, match="data=,model="):
        main(["--device", "cpu", "--arch", ARCH, "--mesh", "model=4",
              "--backend", "gloo", "--ckpt-dir", str(tmp_path)])


def test_compression_on_sharded_leaves_is_refused():
    """``compress_grads`` needs each full leaf: refused on a model axis
    and under ZeRO (checked before any process group is touched)."""
    from types import SimpleNamespace

    from repro_torch.configs import get_smoke_config
    from repro_torch.dist.sharding import (lm_param_shardings,
                                           opt_state_shardings)
    from repro_torch.models.transformer import abstract_params
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.steps import make_train_step
    cfg = get_smoke_config(ARCH)
    shapes = abstract_params(cfg)
    for dims, zero in (((1, 2), False), ((2, 1), True)):
        mesh = SimpleNamespace(axis_names=("data", "model"),
                               shape=dict(zip(("data", "model"), dims)))
        p = lm_param_shardings(cfg, shapes, mesh)
        o = opt_state_shardings(p, mesh, shapes, zero=zero)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_train_step(lambda p, b: 0.0, AdamWConfig(),
                            compress_grads=True, mesh=mesh, param_specs=p,
                            state_specs=o)
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           shape=dict(data=2, model=1))
    p = lm_param_shardings(cfg, shapes, mesh)
    make_train_step(lambda p, b: 0.0, AdamWConfig(), compress_grads=True,
                    mesh=mesh, param_specs=p,
                    state_specs=opt_state_shardings(p, mesh, shapes))

"""The training launcher on a model mesh, and checkpoints across mesh
shapes, on four CPU ranks over gloo.

``launch.train --mesh data=2,model=2 --zero --sp --backend gloo --device
cpu`` (f32 compute) for 3 granite-moe smoke steps: its printed losses
and final checkpoint equal the meshless run's within 1e-5.  Checkpoints
cross mesh shapes: the mesh run's step-2 checkpoint resumed meshless,
and a meshless step-2 checkpoint resumed on the mesh, each end equal to
the straight run (the schedule's length is ``--steps``, so a resumed run
equals the straight one at the same ``--steps``).  The launcher checks
its mesh flags before it starts a process.

DCN-v2 on ``--mesh data=2,model=2 --zero`` (its table sharded by rows):
checkpoints cross mesh shapes both ways; and gradient compression on
sharded leaves: each rank's piece
quantized with the full leaf's scale and draws is bit-equal to the full
leaf's quantizer, and compressed steps on a mesh equal one process's.
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


RECSYS = ("--arch", "dcn-v2", "--batch", "8", "--ckpt-every", "1")
RECSYS_MESH = ("--mesh", "data=2,model=2", "--zero", "--backend", "gloo")


def test_recsys_launcher_on_a_mesh_and_checkpoints_across_shapes(
        tmp_path, capsys):
    """DCN-v2 (the table by rows over ``"model"``, ZeRO moments), f32
    compute, 4 steps checkpointed each: the meshless run's step-2
    checkpoint resumed on the mesh, and the mesh's step-3 checkpoint
    resumed meshless, each end equal to the straight run (one spawn;
    the mesh's own initialisation is ``tests/test_torch_dist_recsys.
    py``'s)."""
    straight = _run(tmp_path / "straight", 4, capsys, *RECSYS)
    want = _final(tmp_path / "straight", 4)
    shutil.copytree(tmp_path / "straight", tmp_path / "cross")
    for step in (3, 4):
        shutil.rmtree(tmp_path / "cross" / f"step_{step:08d}")
    line = _run(tmp_path / "cross", 4, capsys, *RECSYS, *RECSYS_MESH)
    assert "resumed_from=2" in line
    last = [float(x.split(" -> ")[1]) for x in (straight, line)]
    assert last[1] == pytest.approx(last[0], rel=1e-5)
    _hold_equal(_final(tmp_path / "cross", 4), want)
    assert not list((tmp_path / "cross").glob("rendezvous*"))
    shutil.rmtree(tmp_path / "cross" / "step_00000004")
    assert "resumed_from=3" in _run(tmp_path / "cross", 4, capsys, *RECSYS)
    _hold_equal(_final(tmp_path / "cross", 4), want)


# (dims, zero): leaves sharded over model, over data by ZeRO, and both
COMPRESSION = [((1, 4), False), ((4, 1), True), ((2, 2), True),
               ((2, 2), False)]
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(scope="module")
def compressed(tmp_path_factory):
    """The sharded quantizer's gathered leaves for every case, and three
    compressed steps on ``(2, 2)`` with ZeRO, from one 4-rank spawn."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models.convert import numpy_recsys_params
    from torch_dist_workers import compression_cases
    cfg = get_smoke_config("dcn-v2")
    params = numpy_recsys_params(cfg, 0)
    r = np.random.default_rng(3)
    grads = {k: v for k, v in numpy_recsys_params(cfg, 1).items()}
    grads["table"] = grads["table"] * r.random(grads["table"].shape) ** 4
    batches = [{k: v.numpy() for k, v in synthetic_batch(
        cfg, 8, 0, s, "cpu").items()} for s in range(3)]
    cases = [dict(dims=d, zero=z, key=11 + i, params=params, grads=grads)
             for i, (d, z) in enumerate(COMPRESSION)]
    cases.append(dict(dims=(2, 2), zero=True, key=40, params=params,
                      batches=batches, opt=OPT))
    out = run_on_mesh(compression_cases, 4,
                      str(tmp_path_factory.mktemp("compress") / "rdv"),
                      args=(cases,), timeout_s=600)
    return cfg, params, grads, batches, out[0]


@pytest.mark.parametrize("i", range(len(COMPRESSION)),
                         ids=[f"{d}-zero={z}" for d, z in COMPRESSION])
def test_sharded_compression_is_the_full_leaf_quantizer(compressed, i):
    """Each rank quantizes its piece (model-sharded rows, ZeRO slices)
    with the full leaf's scale and draws: gathered, bit-equal to
    ``compress_decompress`` on the full leaf (the port's, and the
    reference's) under the same key."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.train import steps as js
    from repro_torch.core import rng
    from repro_torch.train import pytree
    from repro_torch.train.steps import compress_decompress
    _, _, grads, _, out = compressed
    got = out[i]["quantized"]
    leaves = pytree.leaves(grads)
    keys = rng.split(rng.PRNGKey(11 + i), len(leaves))
    with jax.enable_x64(False):
        jkeys = jax.random.split(jax.random.PRNGKey(11 + i), len(leaves))
        for g, k, jk, q in zip(leaves, keys, jkeys, got, strict=True):
            want = compress_decompress(torch.as_tensor(g), k).numpy()
            assert np.array_equal(q, want)
            assert np.array_equal(q, np.asarray(js.compress_decompress(
                jnp.asarray(g), jk)))


def test_compressed_steps_on_a_mesh_match_one_process(compressed):
    """``make_train_step(compress_grads=True)`` on ``(2, 2)`` with ZeRO:
    three steps' losses and the final params within 1e-5 of one process
    under the same keys."""
    import torch
    from functools import partial

    from repro_torch.core import rng
    from repro_torch.models import recsys
    from repro_torch.models.convert import recsys_from_numpy
    from repro_torch.train import pytree
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_train_step
    cfg, params, _, batches, out = compressed
    got = out[-1]
    p = recsys_from_numpy(cfg, params, device="cpu")
    opt = adamw_init(p)
    step = make_train_step(partial(recsys.train_loss, cfg,
                                   compute_dtype=torch.float32),
                           AdamWConfig(**OPT), compress_grads=True)
    for i, b in enumerate(batches):
        p, opt, m = step(p, opt, {k: torch.as_tensor(v)
                                  for k, v in b.items()},
                         rng.PRNGKey(40 + i))
        assert got["losses"][i] == pytest.approx(float(m["loss"]), rel=1e-5)
    for a, b in zip(got["params"], pytree.leaves(p), strict=True):
        b = b.numpy()
        assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b)

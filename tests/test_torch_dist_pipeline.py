"""GPipe (``dist.pipeline.gpipe_forward``) on ``(pod=4, data=2,
model=1)``: eight CPU ranks over gloo (one spawn), the reference test's
shapes (4 stages of ``tanh(h @ W)``, 6 microbatches of 2 x 16).

Every rank's output is within 1e-5 of serial application and of the
reference's ``gpipe_forward`` (a subprocess with 8 host devices on its
``(pod=4, data=2)`` mesh), and a stack with a stage too few raises the
reference's ``ValueError``.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro_torch.launch.mesh import run_on_mesh
from torch_dist_workers import pipeline_cases

REPO = Path(__file__).resolve().parents[1]
N_STAGE, N_MB, B, D = 4, 6, 2, 16

SUB = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.dist.pipeline import gpipe_forward
ws, xs = pickle.load(open(sys.argv[1], "rb"))
mesh = jax.make_mesh((4, 2), ("pod", "data"))
out = gpipe_forward(lambda W, h: jnp.tanh(h @ W), jnp.asarray(ws),
                    jnp.asarray(xs), mesh, axis="pod")
np.save(sys.argv[2], np.asarray(out))
"""


def inputs():
    r = np.random.default_rng(1)
    ws = (r.normal(size=(N_STAGE, D, D)) * 0.3).astype(np.float32)
    xs = r.normal(size=(N_MB, B, D)).astype(np.float32)
    return ws, xs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    ws, xs = inputs()
    tmp = tmp_path_factory.mktemp("gpipe")
    out = run_on_mesh(pipeline_cases, 8, str(tmp / "rdv"),
                      args=(dict(dims=(4, 2, 1), ws=ws, xs=xs),),
                      timeout_s=300)
    return ws, xs, out, tmp


def test_gpipe_matches_serial_on_every_rank(run):
    ws, xs, out, _ = run
    want = xs.astype(np.float64)
    for w in ws:
        want = np.tanh(want @ w)
    for r in out:
        np.testing.assert_allclose(r["out"], want, rtol=1e-5, atol=1e-5)


def test_gpipe_matches_reference(run):
    ws, xs, out, tmp = run
    src = tmp / "inputs.pkl"
    src.write_bytes(pickle.dumps((ws, xs)))
    dst = tmp / "reference.npy"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                        str(src), str(dst)], capture_output=True, text=True,
                       cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    want = np.load(dst)
    for rank in out:
        np.testing.assert_allclose(rank["out"], want, rtol=1e-5, atol=1e-5)


def test_stage_count_must_match_the_axis(run):
    for r in run[2]:
        assert r["raised"] == "3 stages on a 4-deep 'pod' axis"


@pytest.mark.parametrize("op", ["ppermute 1", "ppermute -1", "ppermute 2",
                                "psum", "divide_grad", "pmax"])
def test_collectives_under_autograd(run, op):
    for r in run[2]:
        assert r["seen"][op], op

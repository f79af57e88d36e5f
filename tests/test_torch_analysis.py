"""The port's contract linter (``repro_torch.analysis``) and its rebuild
sentinel:

* every kept rule fires on its minimal trigger and passes its clean
  idiom (the pairs of ``tests/test_analysis.py``, on ``repro_torch/...``
  paths), the torch extensions included;
* where both linters read the same snippet -- under ``repro/<layer>/``
  for the reference, ``repro_torch/<layer>/`` for the port -- they
  report the same findings (rule, line, column);
* suppression mechanics, the CLI's exit codes, and the port's tree
  lints clean through ``python -m repro_torch.analysis.lint``;
* ``no_rebuild`` raises on a faked build or load and is silent without.
"""
from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import lint_file as ref_lint_file
from repro_torch.analysis import (RULES, RebuildError, lint_file,
                                  no_rebuild)
from repro_torch.analysis.lint import main
from repro_torch.kernels import _build

REPO = Path(__file__).resolve().parents[1]
KEPT = {"env-seam", "det-key-origin", "det-cohort-key", "det-host-rng",
        "exact-narrowing-cast", "resilience-bare-except",
        "obs-span-discipline"}


def corpus(tmp_path, rel, source):
    """Write a fixture module under a scope-mimicking relative path."""
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return str(path)


def fired(path, rule=None):
    found = lint_file(path)
    return ({f.rule for f in found} if rule is None
            else [f for f in found if f.rule == rule])


# ---------------------------------------------------------------------------
# bad / clean pairs, one or more per kept rule
# ---------------------------------------------------------------------------
ENV_BAD = {
    "read": """
        import os

        def f():
            return os.environ.get("HOME")
    """,
    "write": """
        import os

        def f(backend):
            os.environ["REPRO_SAMPLER_BACKEND"] = backend
    """,
    "getenv": """
        from os import getenv

        def f():
            return getenv("REPRO_BAR")
    """,
}


@pytest.mark.parametrize("case", sorted(ENV_BAD))
def test_env_seam_fires_anywhere(tmp_path, case):
    # no knob registry: any read or write, in any layer
    p = corpus(tmp_path, f"repro_torch/launch/bad_{case}.py", ENV_BAD[case])
    assert len(fired(p, "env-seam")) == 1


def test_env_seam_clean(tmp_path):
    p = corpus(tmp_path, "repro_torch/launch/ok_env.py", """
        import os

        def f(path, device="cuda"):
            return os.path.join(path, device)
    """)
    assert "env-seam" not in fired(p)
    # the reference's registry module has no counterpart in the port
    q = corpus(tmp_path, "repro_torch/knobs.py", ENV_BAD["read"])
    assert "env-seam" in fired(q)


def test_det_key_origin_pair(tmp_path):
    bad = corpus(tmp_path, "repro_torch/core/bad_keys.py", """
        from . import rng as _rng

        def chunk_key(seed, j):
            return _rng.PRNGKey(seed + j)
    """)
    assert len(fired(bad, "det-key-origin")) == 1
    ok = corpus(tmp_path, "repro_torch/core/ok_keys.py", """
        from . import rng as _rng

        def chunk_key(seed, j):
            return _rng.fold_in(_rng.PRNGKey(seed), j)
    """)
    assert fired(ok) == set()


def test_det_cohort_key_pair(tmp_path):
    bad = corpus(tmp_path, "repro_torch/stream/bad_cohort.py", """
        from ..core import rng as _rng

        def stream_key(base_key, job, lane):
            k = _rng.fold_in(base_key, job.motif_index)
            return _rng.fold_in(k, lane)
    """)
    assert len(fired(bad, "det-cohort-key")) == 2
    ok = corpus(tmp_path, "repro_torch/core/ok_cohort.py", """
        from . import rng as _rng

        def chunk_key(base_key, j):
            return _rng.fold_in(base_key, j)
    """)
    assert fired(ok) == set()


def test_det_host_rng_pair(tmp_path):
    bad = corpus(tmp_path, "repro_torch/core/bad_rng.py", """
        import random

        import numpy as np
        import torch

        def f(x):
            a = random.random()
            b = np.random.randint(10)
            c = np.random.default_rng()
            d = torch.randn(4)
            e = torch.randint(0, 9, (3,))
            x.uniform_()
            return a, b, c, d, e
    """)
    assert len(fired(bad, "det-host-rng")) == 6
    ok = corpus(tmp_path, "repro_torch/kernels/ok_rng.py", """
        import numpy as np
        import torch

        def f(seed, x):
            g = torch.Generator().manual_seed(seed)
            a = torch.randn(4, generator=g)
            x.normal_(generator=g)
            torch.nn.init.trunc_normal_(x, 0.0, 1.0, -3.0, 3.0, generator=g)
            return a, np.random.default_rng(seed)
    """)
    assert fired(ok) == set()


def test_exact_narrowing_cast_pair(tmp_path):
    bad = corpus(tmp_path, "repro_torch/kernels/bad_cast.py", """
        import numpy as np
        import torch

        def pack(acc, w_own, cnt):
            a = acc.float() + w_own.to(torch.float32)
            b = cnt.int() + torch.as_tensor(acc, dtype=torch.int32)
            return a, b, acc.astype(np.float32)
    """)
    assert len(fired(bad, "exact-narrowing-cast")) == 5
    ok = corpus(tmp_path, "repro_torch/core/ok_cast.py", """
        import torch

        _F32_EXACT_MAX = float(2 ** 24)

        def narrow(acc, scores):
            # sound: module declares the 2^24 f32-exact envelope above
            return acc.float(), scores.to(torch.float32)
    """)
    assert fired(ok) == set()
    # not a weight name: a plain float cast passes without the guard
    plain = corpus(tmp_path, "repro_torch/core/plain_cast.py", """
        def f(scores, logits):
            return scores.float(), logits.to(dtype=logits.dtype)
    """)
    assert fired(plain) == set()


def test_resilience_bare_except_pair(tmp_path):
    bad = corpus(tmp_path, "repro_torch/gateway/bad_except.py", """
        def drain(session, out):
            try:
                session.flush()
            except Exception:
                pass
            try:
                out.flush()
            except:
                out = None
    """)
    assert len(fired(bad, "resilience-bare-except")) == 2
    ok = corpus(tmp_path, "repro_torch/stream/ok_except.py", """
        from ..resilience import classify, error_payload

        def emit(out, obj, log):
            try:
                out.write(obj)
            except Exception as e:
                log(error_payload(e))
            try:
                out.flush()
            except Exception as e:
                log(classify(e))
            try:
                out.close()
            except Exception:
                raise
    """)
    assert fired(ok) == set()


def test_obs_span_discipline_pair(tmp_path):
    bad = corpus(tmp_path, "repro_torch/core/engine.py", """
        import time
        from time import perf_counter

        def wait(q, timeout):
            deadline = time.monotonic() + timeout
            return deadline, perf_counter()
    """)
    assert len(fired(bad, "obs-span-discipline")) == 2
    ok = corpus(tmp_path, "repro_torch/gateway/ok_clock.py", """
        import time

        from .. import obs

        def wait(timeout):
            time.sleep(0.01)
            return obs.monotonic() + timeout
    """)
    assert fired(ok) == set()
    seam = corpus(tmp_path, "repro_torch/obs/clockish.py", """
        from time import monotonic, perf_counter
    """)
    assert fired(seam) == set()


def test_every_kept_rule_has_a_trigger():
    assert set(RULES) == KEPT


# ---------------------------------------------------------------------------
# the same findings as the reference's linter on shared snippets
# ---------------------------------------------------------------------------
SHARED = {
    "core/keys.py": """
        import jax

        def chunk_key(seed, j):
            return jax.random.PRNGKey(seed * 31 + j)
    """,
    "stream/cohort.py": """
        import jax

        def keys(base_key, j, lane):
            return jax.random.fold_in(jax.random.fold_in(base_key, j), lane)
    """,
    "core/rng.py": """
        import random

        import numpy as np

        def f():
            return random.random(), np.random.randint(10), \\
                np.random.default_rng()
    """,
    "kernels/cast.py": """
        import jax.numpy as jnp

        def pack(acc, w_own):
            return acc.astype(jnp.float32) + jnp.asarray(w_own, jnp.int32)
    """,
    "api/handlers.py": """
        def drain(session, out):
            try:
                session.flush()
            except Exception:
                pass
            try:
                out.write("x")
            except (Exception, OSError) as e:
                print(e)
    """,
    "gateway/clock.py": """
        import time
        import time as _t
        from time import perf_counter

        def wait(q, timeout):
            deadline = time.monotonic() + timeout
            while _t.monotonic() < deadline:
                q.get_nowait()
    """,
    "core/env.py": """
        import os

        def f():
            return os.getenv("HOME"), os.environ.get("REPRO_FOO")
    """,
    "launch/env.py": """
        import os

        def f(backend):
            os.environ["REPRO_SAMPLER_BACKEND"] = backend
    """,
}


@pytest.mark.parametrize("rel", sorted(SHARED))
def test_same_findings_as_reference(tmp_path, rel):
    ref = corpus(tmp_path / "ref", f"repro/{rel}", SHARED[rel])
    port = corpus(tmp_path / "port", f"repro_torch/{rel}", SHARED[rel])
    want = sorted((f.rule, f.line, f.col) for f in ref_lint_file(ref))
    got = sorted((f.rule, f.line, f.col) for f in lint_file(port))
    assert want and got == want


# ---------------------------------------------------------------------------
# suppressions, CLI, the port's tree
# ---------------------------------------------------------------------------
def test_suppressions(tmp_path):
    ok = corpus(tmp_path, "repro_torch/launch/sup.py", """
        import os

        def f():
            # repro-lint: disable=env-seam(a fixture of this test)
            return os.environ.get("HOME")
    """)
    assert fired(ok) == set()
    bare = corpus(tmp_path, "repro_torch/launch/sup_bare.py", """
        import os

        def f():
            return os.environ.get("HOME")  # repro-lint: disable=env-seam
    """)
    assert fired(bare) == {"suppression-missing-reason", "env-seam"}
    unknown = corpus(tmp_path, "repro_torch/launch/sup_unknown.py", """
        x = 1  # repro-lint: disable=retrace-static-argnames(not ported)
    """)
    assert fired(unknown) == {"suppression-missing-reason"}


def test_cli_exit_codes(tmp_path, capsys):
    bad = corpus(tmp_path, "repro_torch/core/bad_keys.py", """
        from . import rng

        def f(seed, j):
            return rng.PRNGKey(seed * 31 + j)
    """)
    assert main([bad]) == 1
    out = capsys.readouterr().out
    assert "bad_keys.py:5:" in out and "det-key-origin" in out
    assert main([corpus(tmp_path, "repro_torch/core/ok.py", "x = 1\n")]) == 0
    assert main(["--list-rules"]) == 0
    assert main([str(tmp_path / "does_not_exist")]) == 2


def test_port_tree_lints_clean():
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint",
                        "src/repro_torch"], capture_output=True, text=True,
                       cwd=REPO, env={"PYTHONPATH": str(REPO / "src"),
                                      "PATH": "/usr/bin:/bin"}, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "clean (7 rules)" in r.stdout


# ---------------------------------------------------------------------------
# no_rebuild
# ---------------------------------------------------------------------------
class _Done:
    returncode = 0

    def communicate(self):
        return "", None


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """``_build`` compiling into ``tmp_path`` with a fake ``nvcc`` and
    loading with a fake ``ctypes.CDLL``: nothing touches the card."""
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_stale", lambda name: True)

    def start(name):
        tmp = tmp_path / f"{name}.tmp.so"
        tmp.write_bytes(b"")
        return _Done(), tmp
    monkeypatch.setattr(_build, "_start", start)
    monkeypatch.setattr(_build, "library_path",
                        lambda name: tmp_path / f"{name}.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())


def test_no_rebuild_raises_on_a_build(fake_build):
    with pytest.raises(RebuildError, match="1 kernel build"):
        with no_rebuild():
            _build.build(["embedding_bag"])


def test_no_rebuild_raises_on_a_load(fake_build):
    with pytest.raises(RebuildError, match="load"):
        with no_rebuild():
            _build.library("embedding_bag")


def test_no_rebuild_silent_without_one(fake_build):
    _build.library("embedding_bag")          # warm: built and loaded
    with no_rebuild() as probe:
        _build.library("embedding_bag")      # already loaded: nothing
    assert (probe.builds, probe.loads) == (0, 0)
    with pytest.raises(RebuildError):        # allow_new allows no build
        with no_rebuild(allow_new=True):
            _build.library("segment_matmul")


def test_no_rebuild_allows_first_loads_when_asked(fake_build, monkeypatch):
    monkeypatch.setattr(_build, "_stale", lambda name: False)
    with no_rebuild(allow_new=True) as probe:
        _build.library("flash_attention")    # built already: a first load
    assert (probe.builds, probe.loads) == (0, 1)
    assert probe.loaded == ("flash_attention",)

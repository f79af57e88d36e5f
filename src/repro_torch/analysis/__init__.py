"""The port's contract linter and rebuild sentinel: its invariants as
checks (the port of ``repro.analysis``, with its scopes on the port's
paths: the reference's ``repro/core/``-style scopes are no substring of
any ``repro_torch/...`` path, so its scoped rules never reach the port).

**Kept rules**, adapted to the port's code:

* ``env-seam`` -- the port reads no environment variable anywhere and
  writes none: every setting is an argument.  There is no knob
  registry, so every ``os.environ`` / ``os.getenv`` access is a finding
  (the reference allows ``REPRO_*`` reads in ``repro/knobs.py``).
* ``det-key-origin``, ``det-cohort-key`` -- in the estimator layers
  (``core/``, ``kernels/``, ``stream/``) base keys come from a seed and
  per-unit keys from ``fold_in(base_key, j)``, never with a motif or
  lane index folded in.  The port's ``core.rng`` keeps jax's threefry
  keys, so the rules read the same calls.
* ``det-host-rng`` -- stdlib ``random``, numpy's global RNG, and
  (extended) torch's global generator: ``torch.rand*`` / ``randn`` /
  ``randint`` / ``randperm`` / ``normal_`` / ``uniform_`` ... without
  ``generator=``.
* ``exact-narrowing-cast`` -- int64 weight / count accumulators narrowed
  without the ``_F32_EXACT_MAX`` guard: numpy's ``astype`` / ``asarray``
  and (extended) torch's ``.float()`` / ``.int()`` / ``.to(torch.
  float32)`` / ``as_tensor(..., dtype=)``.
* ``resilience-bare-except`` -- broad handlers in ``api/``,
  ``stream/``, ``resilience/`` and ``gateway/`` classify or re-raise.
* ``obs-span-discipline`` -- ``obs/``, ``gateway/`` and
  ``core/engine.py`` read the clock through ``repro_torch.obs`` only.

**Dropped rules** (no torch counterpart):

* ``retrace-static-argnames`` and ``retrace-scalar-capture`` police
  ``jax.jit`` sites: parameters that reach shapes must be static, and
  closures must not bake per-call scalars into a trace.  The port jits
  nothing: its kernels are CUDA C++ built once by ``nvcc`` and called
  with runtime arguments, and its torch ops run eagerly, so a per-call
  value never specializes a compiled program.
* ``det-impure-in-traced`` polices code inside jit and Pallas bodies,
  where a wall-clock read or a set's order is frozen into a compiled
  program.  The port has no traced Python bodies (its device code is
  CUDA C++), and eager host code runs anew every call.
* ``no_retrace`` (the reference's sentinel) watches jit caches; its
  counterpart here is ``no_rebuild`` (``sentinel.py``), which fails a
  warm region that builds or loads a kernel library.

**Running it**::

    python -m repro_torch.analysis.lint src/repro_torch   # exit 0 = clean
    python -m repro_torch.analysis.lint --list-rules

Exit status: 0 clean, 1 findings, 2 usage (a path that does not exist).
**Suppressing a finding**: the reference's comment, on the flagged line
or the one above, ``# repro-lint: disable=rule-id(reason)``; the reason
is mandatory (``suppression-missing-reason``).

Import note: this package imports no torch at module load; only
:func:`no_rebuild` touches ``repro_torch.kernels._build``, when entered.
"""
from . import rules as _rules  # noqa: F401  (registers the rule set)
from .registry import RULES
from .report import Finding
from .sentinel import RebuildError, no_rebuild

__all__ = ["Finding", "RULES", "RebuildError", "lint_file", "lint_paths",
           "main", "no_rebuild"]


def __getattr__(name):
    # lint is imported lazily so `python -m repro_torch.analysis.lint`
    # doesn't import the module twice (runpy warns when __init__
    # pre-imports it)
    if name in ("lint_file", "lint_paths", "main"):
        from . import lint
        return getattr(lint, name)
    raise AttributeError(name)

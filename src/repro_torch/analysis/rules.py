"""The port's contract-rule families (see ``analysis/__init__`` for the
policy guide; each rule documents the hazard that motivated it).

Every rule is a pure function ``check(module) -> [Finding]`` over the
:class:`walker.Module` indexes, registered under the reference's
kebab-case id.  The kept rules match the reference's where the port's
code has the same shapes (``.PRNGKey`` / ``.fold_in`` calls, numpy's
global RNG, ``astype`` narrowing, broad handlers, raw clock reads), and
extend them to torch's: its global RNG, and ``.float()`` / ``.int()`` /
``.to(torch.float32)`` narrowing.  A false positive is suppressed in
place with a written reason; a false negative is a missing rule, added
here with its trigger snippet in ``tests/test_torch_analysis.py``.
"""
from __future__ import annotations

import ast
import re

from .registry import (DETERMINISM_SCOPES, ESTIMATOR_SCOPES, OBS_SCOPES,
                       RESILIENCE_SCOPES, register)
from .report import Finding


def _find(rule: str, mod, node: ast.AST, message: str) -> Finding:
    return Finding(rule=rule, path=mod.path, line=node.lineno,
                   col=node.col_offset, message=message)


def _dotted_chain(node: ast.AST) -> list:
    """``np.random.randint`` -> ["np", "random", "randint"] (else [])."""
    parts: list = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return []


# ---------------------------------------------------------------------------
# family: env-seam
# ---------------------------------------------------------------------------
def _is_environ_expr(mod, node: ast.AST) -> bool:
    if isinstance(node, ast.Name) and node.id in mod.environ_aliases:
        return True
    return (isinstance(node, ast.Attribute) and node.attr == "environ"
            and isinstance(node.value, ast.Name)
            and node.value.id in mod.os_aliases)


def _is_getenv_call(mod, call: ast.Call) -> bool:
    f = call.func
    if isinstance(f, ast.Name) and f.id in mod.getenv_aliases:
        return True
    return (isinstance(f, ast.Attribute) and f.attr == "getenv"
            and isinstance(f.value, ast.Name)
            and f.value.id in mod.os_aliases)


@register(
    "env-seam", "env-seam",
    "the port reads no environment variable anywhere and writes none: "
    "every setting is an argument (a CLI flag, EstimateConfig, a "
    "function's parameter), so there is no knob registry and every "
    "os.environ / os.getenv read or write is a finding.")
def check_env_seam(mod) -> list:
    out: list = []
    seen: set = set()

    def flag(node, write=False):
        key = (node.lineno, node.col_offset)
        if key in seen:
            return
        seen.add(key)
        if write:
            msg = ("mutating the environment via os.environ: settings "
                   "thread through explicit arguments, not ambient "
                   "process state")
        else:
            msg = ("environment read in the port: it takes every setting "
                   "as an argument (a flag, EstimateConfig, a parameter), "
                   "never from ambient process state")
        out.append(_find("env-seam", mod, node, msg))

    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Attribute)
                    and f.attr in ("get", "setdefault", "pop")
                    and _is_environ_expr(mod, f.value)):
                flag(node, write=f.attr in ("setdefault", "pop"))
            elif _is_getenv_call(mod, node):
                flag(node)
        elif isinstance(node, ast.Subscript):
            if _is_environ_expr(mod, node.value):
                flag(node, write=isinstance(node.ctx, (ast.Store, ast.Del)))
    return out


# ---------------------------------------------------------------------------
# family: determinism
# ---------------------------------------------------------------------------
def _seedish(arg: ast.AST) -> bool:
    if isinstance(arg, ast.Constant):
        return True
    if isinstance(arg, ast.Call) and isinstance(arg.func, ast.Name) \
            and arg.func.id == "int" and arg.args:
        return _seedish(arg.args[0])
    if isinstance(arg, ast.Name):
        return "seed" in arg.id.lower()
    if isinstance(arg, ast.Attribute):
        return "seed" in arg.attr.lower()
    return False


@register(
    "det-key-origin", "determinism",
    "inside the estimator layers, PRNG base keys come from a seed and "
    "per-unit keys from fold_in(base_key, j) -- PRNGKey(seed + j)-style "
    "arithmetic collides across (seed, unit) pairs and breaks the "
    "bit-identity contract (the port's core.rng keeps jax's threefry "
    "keys, so the rule reads the same calls).",
    scope=DETERMINISM_SCOPES)
def check_key_origin(mod) -> list:
    out: list = []
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "PRNGKey"):
            continue
        arg = node.args[0] if node.args else None
        if arg is None or _seedish(arg):
            continue
        out.append(_find(
            "det-key-origin", mod, node,
            "PRNGKey derived from a computed expression: base keys must "
            "come straight from a seed, and per-chunk/per-unit keys from "
            "fold_in(base_key, j) (the engine determinism contract) -- "
            "seed arithmetic aliases key streams across runs"))
    return out


def _motif_laneish(arg: ast.AST) -> str | None:
    """Name/attribute under ``arg`` that smells like a motif/lane index."""
    for n in ast.walk(arg):
        ident = None
        if isinstance(n, ast.Name):
            ident = n.id
        elif isinstance(n, ast.Attribute):
            ident = n.attr
        if ident is not None and re.search(r"motif|lane", ident,
                                           re.IGNORECASE):
            return ident
    return None


@register(
    "det-cohort-key", "determinism",
    "a tree-cohort's sample stream is SHARED by every member motif: its "
    "keys derive from (seed, chunk) alone.  Folding a motif/lane index "
    "into a sampling key would give each motif a private stream, "
    "breaking the cohort bit-identity contract (a motif's estimate must "
    "not depend on which other motifs joined its cohort).",
    scope=DETERMINISM_SCOPES)
def check_cohort_key(mod) -> list:
    out: list = []
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "fold_in"):
            continue
        for arg in node.args:
            ident = _motif_laneish(arg)
            if ident is not None:
                out.append(_find(
                    "det-cohort-key", mod, node,
                    f"fold_in over {ident!r}: cohort sampling keys derive "
                    "from (seed, chunk) only -- folding a motif/lane index "
                    "in gives that motif a private sample stream, so its "
                    "estimate changes with cohort membership (shared-"
                    "stream determinism contract)"))
                break
    return out


# torch's draws from its global generator unless handed ``generator=``
_TORCH_RNG = {"rand", "randn", "randint", "randperm", "rand_like",
              "randn_like", "randint_like", "normal", "bernoulli",
              "multinomial", "poisson"}
_TORCH_RNG_METHODS = {"normal_", "uniform_", "random_", "exponential_",
                      "bernoulli_", "geometric_", "cauchy_",
                      "log_normal_", "trunc_normal_"}


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


@register(
    "det-host-rng", "determinism",
    "stdlib `random`, numpy global-state RNG and torch's global generator "
    "are banned in the estimator layers; np.random.default_rng(seed) with "
    "an explicit seed and torch draws handed an explicit "
    "generator= are the only sanctioned host RNGs.",
    scope=DETERMINISM_SCOPES)
def check_host_rng(mod) -> list:
    out: list = []
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = (node.names if isinstance(node, ast.Import) else [])
            if any(a.name == "random" for a in names) or (
                    isinstance(node, ast.ImportFrom)
                    and node.module == "random"):
                out.append(_find(
                    "det-host-rng", mod, node,
                    "stdlib `random` in an estimator layer: hidden global "
                    "state breaks run-to-run determinism -- derive "
                    "randomness from threefry keys or a seeded "
                    "np.random.default_rng"))
        elif isinstance(node, ast.Call):
            chain = _dotted_chain(node.func)
            if (len(chain) >= 3 and chain[0] in ("np", "numpy")
                    and chain[1] == "random"):
                if chain[2] == "default_rng":
                    if not node.args:
                        out.append(_find(
                            "det-host-rng", mod, node,
                            "np.random.default_rng() without a seed: "
                            "OS-entropy seeding makes results "
                            "irreproducible -- pass an explicit seed"))
                else:
                    out.append(_find(
                        "det-host-rng", mod, node,
                        f"np.random.{chain[2]} uses numpy's global RNG "
                        "state: call order changes results -- use a "
                        "seeded np.random.default_rng(seed) generator"))
            elif _has_generator(node):
                continue
            elif (len(chain) >= 2 and chain[0] in mod.torch_aliases
                  and chain[-1] in _TORCH_RNG | _TORCH_RNG_METHODS):
                out.append(_find(
                    "det-host-rng", mod, node,
                    f"{'.'.join(chain)}() without generator=: it draws "
                    "from torch's global generator, whose state every "
                    "earlier draw moves -- pass a seeded "
                    "torch.Generator"))
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in _TORCH_RNG_METHODS):
                out.append(_find(
                    "det-host-rng", mod, node,
                    f".{node.func.attr}() without generator=: an in-place "
                    "draw from torch's global generator -- pass a seeded "
                    "torch.Generator"))
    return out


# ---------------------------------------------------------------------------
# family: exactness
# ---------------------------------------------------------------------------
_WEIGHT_IDENT = re.compile(
    r"\b(ps_win|ps_acc\w*|ps_pair\w*|w_own|w_prev|W_total|W_win|acc|cnt2?)\b")
_NARROW_ATTRS = {"float32", "int32", "float16", "bfloat16", "float", "int",
                 "half"}
_NARROW_NAMES = {"_F32", "_I32"}
_NARROW_METHODS = {"float", "int", "half", "bfloat16"}
_GUARD_MARKS = ("_F32_EXACT_MAX", "2 ** 24", "2**24", "1 << 24")


def _is_narrow_dtype(node: ast.AST) -> bool:
    if isinstance(node, ast.Name) and node.id in _NARROW_NAMES:
        return True
    if isinstance(node, ast.Attribute) and node.attr in _NARROW_ATTRS:
        return True
    return (isinstance(node, ast.Constant) and node.value in _NARROW_ATTRS)


def _dtype_arg(call: ast.Call, pos: int):
    """The dtype a call is handed: positional ``pos`` or ``dtype=``."""
    for kw in call.keywords:
        if kw.arg == "dtype":
            return kw.value
    return call.args[pos] if len(call.args) > pos else None


def _narrowed(node: ast.Call):
    """The value a call narrows to a 32-bit (or smaller) type, or None."""
    f = node.func
    if not isinstance(f, ast.Attribute):
        return None
    if f.attr == "astype" and node.args and _is_narrow_dtype(node.args[0]):
        return f.value
    if f.attr in _NARROW_METHODS and not node.args and not node.keywords:
        return f.value
    if f.attr == "to":
        dtype = _dtype_arg(node, 0)
        if dtype is not None and _is_narrow_dtype(dtype):
            return f.value
    if f.attr in ("asarray", "array", "as_tensor", "tensor") and node.args:
        dtype = _dtype_arg(node, 1)
        if dtype is not None and _is_narrow_dtype(dtype):
            return node.args[0]
    return None


@register(
    "exact-narrowing-cast", "exactness",
    "weight/count accumulators are exact int64 (paper Table 7: W up to "
    "~1e15); casting one to f32/int32 (astype, .float(), .int(), "
    ".to(torch.float32)) is only sound inside the declared 2^24 "
    "f32-exact envelope -- the narrowing module must carry the "
    "_F32_EXACT_MAX guard that enforces it.",
    scope=ESTIMATOR_SCOPES)
def check_narrowing_cast(mod) -> list:
    if any(mark in mod.source for mark in _GUARD_MARKS):
        return []   # module declares + enforces the f32-exact envelope
    out: list = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        subject = _narrowed(node)
        if subject is None:
            continue
        text = ast.unparse(subject)
        m = _WEIGHT_IDENT.search(text)
        if m:
            out.append(_find(
                "exact-narrowing-cast", mod, node,
                f"narrowing cast of weight/accumulator value '{text}' "
                "(matched '" + m.group(1) + "') without an adjacent "
                "2^24 exactness guard: f32 holds integers exactly only "
                "below 2^24 -- gate via _F32_EXACT_MAX (and fall back to "
                "the exact int64 path) before narrowing"))
    return out


# ---------------------------------------------------------------------------
# family: resilience
# ---------------------------------------------------------------------------
_BROAD_EXC_NAMES = {"Exception", "BaseException"}
_CLASSIFY_CALLS = {"classify", "error_payload", "is_retryable"}


def _is_broad_exc(node: ast.AST | None) -> bool:
    """Bare ``except:``, ``except Exception``/``BaseException`` (possibly
    dotted or inside a tuple) -- the handlers that can swallow anything."""
    if node is None:
        return True
    if isinstance(node, ast.Tuple):
        return any(_is_broad_exc(el) for el in node.elts)
    if isinstance(node, ast.Name):
        return node.id in _BROAD_EXC_NAMES
    if isinstance(node, ast.Attribute):
        return node.attr in _BROAD_EXC_NAMES
    return False


def _handler_classifies(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True                 # re-raised: nothing is swallowed
        if isinstance(node, ast.Call):
            fn = node.func
            name = (fn.id if isinstance(fn, ast.Name)
                    else fn.attr if isinstance(fn, ast.Attribute) else None)
            if name in _CLASSIFY_CALLS:
                return True
    return False


@register(
    "resilience-bare-except", "resilience",
    "a broad exception handler in the serving stack (api/, stream/, "
    "resilience/, gateway/) that neither re-raises nor routes the "
    "exception through the resilience taxonomy (classify / error_payload "
    "/ is_retryable) silently erases the retryable-vs-fatal distinction: "
    "transient device faults stop reaching the retry ladder and fatal "
    "bugs get retried forever -- every swallowed failure must be "
    "classified or propagated.",
    scope=RESILIENCE_SCOPES)
def check_bare_except(mod) -> list:
    out: list = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not _is_broad_exc(node.type):
            continue
        if _handler_classifies(node):
            continue
        caught = "bare except" if node.type is None else \
            f"except {ast.unparse(node.type)}"
        out.append(_find(
            "resilience-bare-except", mod, node,
            f"{caught} swallows failures without consulting the "
            "resilience taxonomy: call classify()/error_payload()/"
            "is_retryable() on the exception (or re-raise) so "
            "retryable faults reach the retry ladder and fatal ones "
            "surface"))
    return out


# ---------------------------------------------------------------------------
# family: observability
# ---------------------------------------------------------------------------
_OBS_SEAM = "repro_torch/obs/"
_CLOCK_FNS = {"time", "time_ns", "monotonic", "monotonic_ns",
              "perf_counter", "perf_counter_ns"}


@register(
    "obs-span-discipline", "observability",
    "instrumented serving layers read the clock only through the "
    "repro_torch.obs seam (obs.monotonic / obs.span): a raw "
    "time.monotonic()/perf_counter() read is a shadow timing path the "
    "metrics registry and flight recorder cannot see, so stage latencies "
    "silently diverge from the spans that claim to measure them.  "
    "time.sleep stays legal -- the rule bans clock READS, not waiting.",
    scope=OBS_SCOPES)
def check_span_discipline(mod) -> list:
    if _OBS_SEAM in mod.posix:
        return []              # repro_torch/obs/ IS the sanctioned seam
    out: list = []
    time_aliases = {"time"}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "time":
                    time_aliases.add(a.asname or a.name)
        elif isinstance(node, ast.ImportFrom) and node.module == "time":
            clocks = sorted(a.name for a in node.names
                            if a.name in _CLOCK_FNS)
            if clocks:
                out.append(_find(
                    "obs-span-discipline", mod, node,
                    f"from time import {', '.join(clocks)} in an "
                    "instrumented layer: import the clock from "
                    "repro_torch.obs (obs.monotonic / obs.perf_counter) so "
                    "every timing read shares the seam the spans and stage "
                    "histograms use"))
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _dotted_chain(node.func)
        if (len(chain) == 2 and chain[0] in time_aliases
                and chain[1] in _CLOCK_FNS):
            out.append(_find(
                "obs-span-discipline", mod, node,
                f"{'.'.join(chain)}() in an instrumented layer: read the "
                "clock through repro_torch.obs (obs.monotonic, or wrap the "
                "region in obs.span) -- a raw clock read is a shadow "
                "timing path the registry/flight recorder cannot see"))
    return out

"""Rule registry + path scoping for the port's contract linter (the
port of ``repro.analysis.registry``).

Rules register themselves via the :func:`register` decorator (see
``rules.py``); the CLI asks :func:`rules_for` which rules apply to a
given file.  Scoping is by posix-path substring, on the port's paths
(``repro_torch/core/`` ...): the reference's scopes (``repro/core/``)
are no substring of any ``repro_torch/...`` path, so its scoped rules
never reach the port.  There is no knob registry: the port reads no
environment variable anywhere (rule ``env-seam``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

# layers bound by the exactness/determinism contracts
ESTIMATOR_SCOPES = ("repro_torch/core/", "repro_torch/kernels/")
DETERMINISM_SCOPES = ESTIMATOR_SCOPES + ("repro_torch/stream/",)
# serving-stack layers where every swallowed exception must be
# classified through the resilience taxonomy (rule resilience-bare-except)
RESILIENCE_SCOPES = ("repro_torch/api/", "repro_torch/stream/",
                     "repro_torch/resilience/", "repro_torch/gateway/")
# instrumented layers where clock reads must go through the obs seam
# (rule obs-span-discipline; repro_torch/obs/ itself is the seam and is
# exempted inside the rule)
OBS_SCOPES = ("repro_torch/obs/", "repro_torch/gateway/",
              "repro_torch/core/engine.py", "repro_torch/core/batch.py")
EVERYWHERE = ("",)

# pseudo-rule for malformed suppression comments; never suppressible
SUPPRESSION_RULE = "suppression-missing-reason"


@dataclass(frozen=True)
class Rule:
    """One registered lint rule."""

    id: str
    family: str          # env-seam | determinism | exactness | ...
    doc: str
    scope: tuple         # path substrings; ("",) = every file
    check: Callable      # fn(module: walker.Module) -> list[Finding]


RULES: dict[str, Rule] = {}


def register(id: str, family: str, doc: str, scope: tuple = EVERYWHERE):
    """Function decorator: register ``fn(module) -> [Finding]``."""
    def deco(fn):
        if id in RULES:
            raise ValueError(f"duplicate rule id {id!r}")
        RULES[id] = Rule(id=id, family=family, doc=doc, scope=tuple(scope),
                         check=fn)
        return fn
    return deco


def rules_for(posix_path: str) -> list:
    """Rules whose scope matches this file path (substring match)."""
    return [r for r in RULES.values()
            if any(s == "" or s in posix_path for s in r.scope)]


def known_rule(rule_id: str) -> bool:
    return rule_id in RULES or rule_id == "all"

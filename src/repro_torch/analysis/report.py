"""Findings + diagnostics formatting for the port's contract linter (a
copy of ``repro.analysis.report``).

A :class:`Finding` is one rule violation pinned to ``path:line:col``.
The CLI (``lint.py``) prints one diagnostic per line in the classic
compiler format so editors/CI logs can jump straight to the site::

    src/repro_torch/core/engine.py:171:23: env-seam: environment read
    in the port ...

Findings sort by (path, line, col, rule) so output is stable across
runs and dict-ordering details.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: " \
               f"{self.message}"


def sort_findings(findings) -> list:
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule))


def render(findings) -> str:
    """Full report: one diagnostic per line + a summary tail."""
    findings = sort_findings(findings)
    lines = [f.format() for f in findings]
    by_rule: dict[str, int] = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    if findings:
        counts = ", ".join(f"{r}: {n}" for r, n in sorted(by_rule.items()))
        lines.append(f"{len(findings)} finding(s) [{counts}]")
    return "\n".join(lines)

"""Command-line entry point of the port's contract linter (the port of
``repro.analysis.lint``): ``python -m repro_torch.analysis.lint
src/repro_torch``.

Walks the given files/directories, runs every in-scope rule on each
``.py`` file, applies ``# repro-lint: disable=rule(reason)`` suppressions,
and prints one ``path:line:col: rule: message`` diagnostic per surviving
finding.  Exit status: 0 = clean, 1 = findings, 2 = usage/parse errors.

Deliberately import-light: stdlib only (no torch), so it runs before any
heavyweight import.
"""
from __future__ import annotations

import argparse
import os
import sys

from . import rules as _rules  # noqa: F401  (registers the rule set)
from .registry import RULES, SUPPRESSION_RULE, rules_for
from .report import Finding, render, sort_findings

_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "build", "dist"}


def iter_python_files(paths) -> list:
    out: list = []
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                out.append(p)
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS)
                for f in sorted(files):
                    if f.endswith(".py"):
                        out.append(os.path.join(root, f))
    return out


def lint_file(path: str, source: str | None = None) -> list:
    """All surviving findings for one file (suppressions applied)."""
    from .walker import parse_module
    try:
        mod = parse_module(path, source=source)
    except SyntaxError as e:
        return [Finding(rule="parse-error", path=path, line=e.lineno or 1,
                        col=e.offset or 0, message=str(e.msg))]
    findings: list = []
    for rule in rules_for(mod.posix):
        for f in rule.check(mod):
            if not mod.is_suppressed(f.rule, f.line):
                findings.append(f)
    for line, item in mod.bare_suppressions:
        findings.append(Finding(
            rule=SUPPRESSION_RULE, path=path, line=line, col=0,
            message=f"suppression of '{item}' has no written reason: "
                    "the reason is the audit trail — write "
                    f"# repro-lint: disable={item}(why this is safe)"))
    for line, item in mod.unknown_suppressions:
        findings.append(Finding(
            rule=SUPPRESSION_RULE, path=path, line=line, col=0,
            message=f"suppression names unknown rule '{item}' "
                    "(see --list-rules)"))
    return findings


def lint_paths(paths) -> list:
    findings: list = []
    for path in iter_python_files(paths):
        findings.extend(lint_file(path))
    return sort_findings(findings)


def list_rules() -> str:
    lines = []
    for r in RULES.values():
        scope = ", ".join(s or "<everywhere>" for s in r.scope)
        lines.append(f"{r.id}  [{r.family}]  scope: {scope}\n    {r.doc}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="The port's contract linter: determinism, exactness, "
                    "resilience, clock and no-environment invariants as "
                    "static checks.")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to lint (default: "
                         "src/repro_torch)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the registered rules and exit")
    args = ap.parse_args(argv)
    if args.list_rules:
        print(list_rules())
        return 0
    paths = args.paths or ["src/repro_torch"]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"error: no such path: {', '.join(missing)}", file=sys.stderr)
        return 2
    findings = lint_paths(paths)
    if findings:
        print(render(findings))
        return 1
    n = len(iter_python_files(paths))
    print(f"repro-lint: {n} file(s) clean ({len(RULES)} rules)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

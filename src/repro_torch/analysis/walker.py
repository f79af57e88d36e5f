"""Shared AST infrastructure for the port's contract linter (stdlib
``ast`` only; the port of ``repro.analysis.walker``).

Parses one file into a :class:`Module` carrying what the rules read:

* **parent links** -- every node gets ``._rl_parent``;
* **import aliases** -- which local names mean ``os`` / ``environ`` /
  ``getenv`` / stdlib ``random`` / ``torch`` (``import torch as t``,
  ``from os import environ``, ...);
* **suppressions** -- ``# repro-lint: disable=rule(reason)`` comments,
  parsed per line.  A suppression applies to findings on its own line
  and on the line directly below (comment-above style).  ``disable=all``
  suppresses every rule at that site.  A suppression without a written
  reason is itself a finding (the suppression log is the audit trail of
  accepted hazards).

The reference's jit sites and traced-function set have no counterpart:
the port traces nothing (its kernels are CUDA C++ built by ``nvcc``, and
nothing is jitted), so the rules that read them are not ported (see the
package docstring).
"""
from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field

_SUPPRESS_RE = re.compile(r"#\s*repro-lint:\s*disable=(.*)$")
_ITEM_RE = re.compile(r"([\w-]+)\s*(\(([^()]*)\))?")
_SEP_RE = re.compile(r"\s*,\s*")


@dataclass
class Module:
    path: str                          # as given to the CLI
    posix: str                         # normalized with "/" separators
    source: str
    tree: ast.Module
    lines: list = field(default_factory=list)
    os_aliases: set = field(default_factory=set)      # names meaning os
    environ_aliases: set = field(default_factory=set)  # from os import environ
    getenv_aliases: set = field(default_factory=set)   # from os import getenv
    stdlib_random_aliases: set = field(default_factory=set)
    torch_aliases: set = field(default_factory=set)    # names meaning torch
    suppressions: dict = field(default_factory=dict)  # line -> {rule: reason}
    bare_suppressions: list = field(default_factory=list)  # [(line, item)]
    unknown_suppressions: list = field(default_factory=list)

    def parent(self, node: ast.AST):
        return getattr(node, "_rl_parent", None)

    def is_suppressed(self, rule_id: str, line: int) -> bool:
        for at in (line, line - 1):
            rules = self.suppressions.get(at, {})
            if rule_id in rules or "all" in rules:
                return True
        return False


def _link_parents(tree: ast.Module) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._rl_parent = node


def _collect_imports(mod: Module) -> None:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                name = a.asname or a.name
                if a.name == "os":
                    mod.os_aliases.add(name)
                elif a.name == "random":
                    mod.stdlib_random_aliases.add(name)
                elif a.name == "torch":
                    mod.torch_aliases.add(name)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "os":
                for a in node.names:
                    name = a.asname or a.name
                    if a.name == "environ":
                        mod.environ_aliases.add(name)
                    elif a.name == "getenv":
                        mod.getenv_aliases.add(name)
            elif node.module == "random":
                mod.stdlib_random_aliases.add("__from_random__")


def _comment_tokens(source: str):
    """Real COMMENT tokens only -- never text inside string literals."""
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.string
    except tokenize.TokenError:
        return


def _collect_suppressions(mod: Module) -> None:
    from .registry import known_rule
    for line_no, comment in _comment_tokens(mod.source):
        m = _SUPPRESS_RE.search(comment)
        if not m:
            continue
        body = m.group(1).strip()
        entry = mod.suppressions.setdefault(line_no, {})
        pos = 0
        while pos < len(body):
            item = _ITEM_RE.match(body, pos)
            if not item or not item.group(1):
                break
            rule_id, has_reason, reason = (item.group(1), item.group(2),
                                           item.group(3))
            if not has_reason or not (reason or "").strip():
                mod.bare_suppressions.append((line_no, rule_id))
            elif not known_rule(rule_id):
                mod.unknown_suppressions.append((line_no, rule_id))
            else:
                entry[rule_id] = reason.strip()
            pos = item.end()
            sep = _SEP_RE.match(body, pos)
            if not sep:
                break   # anything after the item list is trailing prose
            pos = sep.end()


def parse_module(path: str, source: str | None = None) -> Module:
    if source is None:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    tree = ast.parse(source, filename=path)
    mod = Module(path=path, posix=path.replace("\\", "/"), source=source,
                 tree=tree, lines=source.splitlines())
    _link_parents(tree)
    _collect_imports(mod)
    _collect_suppressions(mod)
    return mod

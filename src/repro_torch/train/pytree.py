"""Parameter trees in jax's flattening order, with jax's key paths.

The port keeps the reference's parameter pytrees as nested dicts, lists,
tuples and NamedTuples of tensors.  The optimizer walks them leaf by
leaf, and the checkpoint names each leaf by its path, so both need the
order and the path strings ``jax.tree_util`` gives:

* dict keys sorted, lists and tuples by index, NamedTuple fields in
  declaration order; ``None`` is an empty node (no leaves); anything
  else is a leaf;
* paths as ``jax.tree_util.keystr`` writes them: ``['layers'][0]['W']``,
  ``.mu['table']``, ``['opt'].step``.

A checkpoint written by either package therefore lists the same paths in
the same order (``train/checkpoint.py``).  The walks are module-level
functions: a nested function that calls itself is a reference cycle,
which would keep the leaves it collected (a 4 GB gradient, say) alive
until the garbage collector runs.
"""
from __future__ import annotations

from typing import Any, Callable

_LEAF = object()


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """``[(key string, child)]`` of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    if node is None:
        return []
    return None


def _walk(node, path: str, out: list) -> None:
    kids = _children(node)
    if kids is None:
        out.append((path, node))
        return
    for key, child in kids:
        _walk(child, path + key, out)


def flatten_with_paths(tree) -> list[tuple[str, Any]]:
    """``[(keystr path, leaf)]`` in jax's leaf order."""
    out: list = []
    _walk(tree, "", out)
    return out


def _skeleton(node):
    kids = _children(node)
    if kids is None:
        return _LEAF
    if isinstance(node, dict):
        return {k: _skeleton(node[k]) for k in node}
    if _is_namedtuple(node):
        return type(node)(*(_skeleton(c) for _, c in kids))
    if isinstance(node, list):
        return [_skeleton(c) for _, c in kids]
    if isinstance(node, tuple):
        return tuple(_skeleton(c) for _, c in kids)
    return None


def flatten(tree):
    """``(leaves, treedef)``; ``unflatten(treedef, leaves)`` rebuilds it."""
    return [leaf for _, leaf in flatten_with_paths(tree)], _skeleton(tree)


def _fill(node, it):
    """Rebuild ``node`` of a treedef from the leaf iterator ``it``; dicts
    are filled in sorted-key order (the leaf order) but keep their own
    key order."""
    if node is _LEAF:
        return next(it)
    if isinstance(node, dict):
        vals = {k: _fill(node[k], it) for k in sorted(node)}
        return {k: vals[k] for k in node}
    if _is_namedtuple(node):
        return type(node)(*(_fill(c, it) for c in node))
    if isinstance(node, list):
        return [_fill(c, it) for c in node]
    if isinstance(node, tuple):
        return tuple(_fill(c, it) for c in node)
    return None


def unflatten(treedef, leaves):
    it = iter(leaves)
    out = _fill(treedef, it)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def leaves(tree) -> list:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), rebuilt as ``tree``."""
    flat, tdef = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError("tree_map: trees of different structure")
    return unflatten(tdef, [fn(*xs) for xs in zip(flat, *others)])

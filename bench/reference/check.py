"""What ``correct`` compares: the answers of whole requests.

Every number compared is an integer count of disagreements with the
reference, whose limit is 0: plans (the chosen tree's motif edges, or
``W``), sums (each of the six int64 sums, and the samples drawn), and
estimates (``W * cnt2 / 2k``, as a float computed the same way).
"""
from __future__ import annotations

from .count import ACC_KEYS


def compare(got: list, want: list) -> dict:
    """Disagreements of the answers ``got`` (dicts as
    ``Reference.run`` gives them, ``None`` for an answer that never
    came) with ``want``."""
    out = dict(plans=0, sums=0, estimates=0, unanswered=0)
    for g, w in zip(got, want, strict=True):
        if g is None:
            out["unanswered"] += 1
            continue
        out["plans"] += int(tuple(g["tree_edges"]) != tuple(w["tree_edges"])
                            or g["W"] != w["W"])
        out["sums"] += sum(int(g[kk] != w[kk]) for kk in (*ACC_KEYS, "k"))
        out["estimates"] += int(g["estimate"] != w["estimate"])
    return out

"""Temporal motifs and their rooted spanning trees (paper Def. 1.1, 4.4,
Alg. 7 and 8): a frozen copy of the port's motif catalog and candidate
enumeration.

Alg. 7 picks the candidate tree of least ``W``; ties go to the first
candidate, so the reference has to list the candidates in the port's
order (looseness, then edge subset; the median-rank root, then the root
of least height).  A tree is kept as plain tuples: ``edges`` (motif edge
ids, pi order = id), ``root`` (tree-local index of the center edge),
``deps[s]`` (``(child, meet_end, alpha, beta)`` of tree edge ``s``),
``topo_down`` (root first) and ``vertex_source`` (the tree edge and end
that introduces each motif vertex).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass

OUT, IN = +1, -1
BEFORE, AFTER = -1, +1


def _cycle(n):
    return tuple((i, (i + 1) % n) for i in range(n))


def _path(n):
    return tuple((i, i + 1) for i in range(n - 1))


def _out_star(n):
    return tuple((0, i) for i in range(1, n))


def _clique(n):
    return tuple(itertools.combinations(range(n), 2))


#: name -> (number of vertices, edges in pi order)
MOTIFS = {
    "M4-1": (4, _path(4)),
    "M4-2": (4, _out_star(4)),
    "M4-3": (4, _cycle(4)),
    "M4-4": (4, ((0, 1), (1, 2), (2, 0), (2, 3))),
    "M4-5": (4, ((0, 1), (0, 2), (0, 3), (1, 2))),
    "M4-7": (4, ((0, 1), (1, 2), (2, 3), (3, 0))),
    "M5-1": (5, _out_star(5)),
    "M5-2": (5, _path(5)),
    "M5-3": (5, _cycle(5)),
    "M5-4": (5, ((0, 1), (0, 2), (1, 2), (0, 3), (1, 3), (2, 3), (3, 4))),
    "M5-5": (5, _clique(5)),
    "M6-1": (6, _out_star(6)),
    "M6-2": (6, ((0, 1), (0, 2), (0, 3), (1, 4), (2, 4), (3, 4), (4, 5))),
    "M6-3": (6, _cycle(6)),
    "M6-4": (6, ((0, 1), (1, 2), (2, 0), (2, 3), (3, 4), (4, 2), (4, 5),
                 (5, 0))),
    "M6-5": (6, _clique(6)),
}


@dataclass(frozen=True)
class Tree:
    motif: str
    nv: int
    motif_edges: tuple      # all motif edges, pi order
    edges: tuple            # motif edge ids of the tree edges
    root: int
    deps: tuple             # per edge: ((child, meet_end, alpha, beta), ..)
    topo_down: tuple
    vertex_source: tuple

    @property
    def S(self) -> int:
        return len(self.edges)

    @property
    def signature(self) -> tuple:
        """What the weights and the sampler read: two trees with equal
        signatures have equal weights and draw equal samples."""
        return (self.nv, self.root, self.deps, self.topo_down,
                self.vertex_source)

    def schedule(self) -> tuple:
        """Sampling order: ``(parent, child, meet_end, alpha, beta,
        use_rev)`` for every dependency, parents first; ``use_rev``
        picks the reversed pair for the Claim 4.8 list."""
        out = []
        for s in self.topo_down:
            for (c, meet_end, alpha, beta) in self.deps[s]:
                use_rev = meet_end != 0 if alpha == OUT else meet_end == 0
                out.append((s, c, meet_end, alpha, beta, int(use_rev)))
        return tuple(out)


def _is_tree(nv, medges, subset) -> bool:
    par = list(range(nv))

    def find(x):
        while par[x] != x:
            par[x] = par[par[x]]
            x = par[x]
        return x

    for eid in subset:
        u, v = medges[eid]
        ru, rv = find(u), find(v)
        if ru == rv:
            return False
        par[ru] = rv
    return True


def build_tree(name: str, subset: tuple, root_edge: int) -> tuple:
    """``(tree, height)``: the tree ``subset`` rooted at motif edge
    ``root_edge`` by a BFS over edges from the root (a child hangs off
    the vertex its parent introduced), and each edge's height."""
    nv, medges = MOTIFS[name]
    local = {eid: i for i, eid in enumerate(subset)}
    k = len(subset)
    ends = [medges[eid] for eid in subset]
    root = local[root_edge]
    deps = [[] for _ in range(k)]
    vsource = {ends[root][0]: (root, 0), ends[root][1]: (root, 1)}
    frontier, visited = [root], {root}
    while frontier:
        nxt = []
        for s in frontier:
            su, sv = ends[s]
            for c in range(k):
                if c in visited:
                    continue
                cu, cv = ends[c]
                shared = {su, sv} & {cu, cv}
                if not shared:
                    continue
                a = next(iter(shared))
                if vsource.get(a, (None, None))[0] != s:
                    continue
                visited.add(c)
                meet_end = 0 if a == su else 1
                alpha = OUT if cu == a else IN
                beta = BEFORE if subset[c] < subset[s] else AFTER
                far, far_end = (cv, 1) if cu == a else (cu, 0)
                deps[s].append((c, meet_end, alpha, beta))
                vsource[far] = (c, far_end)
                nxt.append(c)
        frontier = nxt
    if len(visited) != k:
        raise ValueError(f"{name}: {subset} is not a tree")
    order = []

    def visit(s):
        for d in deps[s]:
            visit(d[0])
        order.append(s)

    visit(root)
    height = [0] * k
    for s in order:
        if deps[s]:
            height[s] = 1 + max(height[d[0]] for d in deps[s])
    return Tree(motif=name, nv=nv, motif_edges=medges, edges=tuple(subset),
                root=root, deps=tuple(tuple(d) for d in deps),
                topo_down=tuple(reversed(order)),
                vertex_source=tuple(vsource[v] for v in range(nv))), height


def looseness(medges, nv, subset) -> int:
    """Alg. 8: sum over vertices of |rank gap - 1| over pairs of tree
    edges meeting there."""
    total = 0
    for u in range(nv):
        inc = [eid for eid in subset if u in medges[eid]]
        for e1, e2 in itertools.combinations(inc, 2):
            total += abs(abs(e1 - e2) - 1)
    return total


def candidates(name: str, n_candidates: int = 3,
               roots_per_tree: int = 2) -> list:
    """Alg. 7's rooted candidates, in the order whose first least-W
    member wins."""
    nv, medges = MOTIFS[name]
    subsets = [s for s in itertools.combinations(range(len(medges)), nv - 1)
               if _is_tree(nv, medges, s)]
    subsets.sort(key=lambda s: (looseness(medges, nv, s), s))
    out = []
    for subset in subsets[:n_candidates]:
        ranked = sorted(subset)
        roots = [ranked[len(ranked) // 2]]
        if roots_per_tree > 1:
            best = None
            for r in subset:
                h = max(build_tree(name, subset, r)[1])
                if best is None or h < best[0]:
                    best = (h, r)
            if best[1] not in roots:
                roots.append(best[1])
        out.extend(build_tree(name, subset, r)[0]
                   for r in roots[:roots_per_tree])
    return out

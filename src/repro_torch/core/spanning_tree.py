"""Spanning trees of temporal motifs (paper Sec. 4 + 4.5).

The port's own copy of ``repro.core.spanning_tree``: the same candidate
order, roots and dependency lists, so both packages pick the same tree.

A spanning tree ``S`` of motif ``M`` is a subset of ``|V(M)|-1`` motif edges
forming a tree on the motif vertices, *rooted at an edge* (the "center" edge).
Rooting induces, for every tree edge ``s``, a dependency list ``D(s)`` of
triples <child, alpha, beta> (paper Def. 4.4):

* ``meet_end``  — which endpoint of the *parent* motif edge the child attaches
                  to (0 = src, 1 = dst).  This is static: a graph edge ``e``
                  matched to ``s`` always maps src(s)->src(e), dst(s)->dst(e).
* ``alpha``     — child direction at the meeting vertex (+1 outgoing / -1 in).
* ``beta``      — relative pi-order (-1 child earlier than parent, +1 later).

The module also implements the constraint-looseness heuristic (Alg. 8) and
spanning-tree enumeration (Alg. 7 step 1).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass

from .motif import TemporalMotif

OUT = +1
IN = -1
BEFORE = -1
AFTER = +1


@dataclass(frozen=True)
class Dependency:
    """One <s', alpha, beta> triple of D(s), in tree-local indices."""

    child: int      # position of the child edge within SpanningTree.edge_ids
    meet_end: int   # 0: child attaches at src(parent edge); 1: at dst(parent)
    alpha: int      # OUT / IN: child direction at the meeting vertex
    beta: int       # BEFORE / AFTER: child pi-rank vs parent pi-rank
    child_far_end: int  # 0/1: which end of the *child* edge is the far (new) vertex


@dataclass(frozen=True)
class SpanningTree:
    """A rooted spanning tree of a temporal motif, with its DP schedule."""

    motif: TemporalMotif
    edge_ids: tuple[int, ...]          # motif-edge ids of the tree edges
    root: int                          # tree-local index of the center edge
    parent: tuple[int, ...]            # tree-local parent index (-1 for root)
    deps: tuple[tuple[Dependency, ...], ...]   # D(s) per tree-local index
    height: tuple[int, ...]            # per tree edge; leaves = 0
    # sampling order: root first, then BFS order down the tree
    topo_down: tuple[int, ...]
    # vertex introduction: motif vertex -> (tree-local edge, end 0/1)
    vertex_source: tuple[tuple[int, int], ...]

    @property
    def num_edges(self) -> int:
        return len(self.edge_ids)

    @property
    def non_tree_edge_ids(self) -> tuple[int, ...]:
        tree = set(self.edge_ids)
        return tuple(i for i in range(self.motif.num_edges) if i not in tree)

    def motif_edge(self, local: int) -> tuple[int, int]:
        return self.motif.edges[self.edge_ids[local]]

    def rank(self, local: int) -> int:
        return self.edge_ids[local]  # pi rank == motif edge id

    def describe(self) -> str:
        lines = [f"tree over motif {self.motif.name}: edges {self.edge_ids}, "
                 f"root={self.edge_ids[self.root]}"]
        for s in self.topo_down:
            u, v = self.motif_edge(s)
            ds = ", ".join(
                f"<e{self.edge_ids[d.child]} at {'src' if d.meet_end == 0 else 'dst'} "
                f"{'out' if d.alpha == OUT else 'in'} {'<' if d.beta == BEFORE else '>'}>"
                for d in self.deps[s])
            lines.append(f"  e{self.edge_ids[s]}=({u}->{v}) h={self.height[s]} D=[{ds}]")
        return "\n".join(lines)


def tree_signature(tree: SpanningTree) -> tuple:
    """Structural identity of a rooted tree, independent of its host motif.

    The sampler (``core.sampler``, ``kernels/tree_sampler``) and the
    weight DP (``core.weights``) consume only the fields hashed here —
    root, parent links, dependency triples, topo order and vertex
    introduction — never ``edge_ids`` or the motif's non-tree edges,
    which matter only to per-motif validation (``core.validate``).  Two
    trees with equal signatures therefore preprocess to identical
    ``Weights`` and draw identical sample streams.
    """
    return (tree.motif.num_vertices, tree.root, tree.parent, tree.deps,
            tree.topo_down, tree.vertex_source)


def _is_tree(motif: TemporalMotif, subset: tuple[int, ...]) -> bool:
    n = motif.num_vertices
    if len(subset) != n - 1:
        return False
    par = list(range(n))

    def find(x: int) -> int:
        while par[x] != x:
            par[x] = par[par[x]]
            x = par[x]
        return x

    for eid in subset:
        u, v = motif.edges[eid]
        ru, rv = find(u), find(v)
        if ru == rv:
            return False
        par[ru] = rv
    return True


def tree_edge_subsets(motif: TemporalMotif) -> list[tuple[int, ...]]:
    """All spanning-tree edge subsets of the motif (DFS/enumeration, Alg. 7 l.1)."""
    m = motif.num_edges
    n = motif.num_vertices
    out = []
    for subset in itertools.combinations(range(m), n - 1):
        if _is_tree(motif, subset):
            out.append(subset)
    return out


def build_tree(motif: TemporalMotif, subset: tuple[int, ...], root_edge: int
               ) -> SpanningTree:
    """Root ``subset`` at motif edge ``root_edge`` and derive D(s) lists."""
    if root_edge not in subset:
        raise ValueError("root edge must be a tree edge")
    local = {eid: i for i, eid in enumerate(subset)}
    k = len(subset)
    ends = [motif.edges[eid] for eid in subset]

    # BFS over edge-adjacency starting at the root edge.
    root = local[root_edge]
    parent = [-2] * k
    parent[root] = -1
    deps: list[list[Dependency]] = [[] for _ in range(k)]
    # vertex -> introducing (tree edge, end); root edge introduces both ends
    vsource: dict[int, tuple[int, int]] = {}
    vsource[ends[root][0]] = (root, 0)
    vsource[ends[root][1]] = (root, 1)
    frontier = [root]
    visited = {root}
    while frontier:
        nxt: list[int] = []
        for s in frontier:
            su, sv = ends[s]
            for c in range(k):
                if c in visited:
                    continue
                cu, cv = ends[c]
                shared = {su, sv} & {cu, cv}
                if not shared:
                    continue
                # In an edge-rooted tree children attach at the vertex already
                # introduced; both ends shared cannot happen (tree, no cycle).
                a = next(iter(shared))
                # only attach if the shared vertex was introduced by s itself
                if vsource.get(a, (None, None))[0] != s:
                    continue
                visited.add(c)
                parent[c] = s
                meet_end = 0 if a == su else 1
                alpha = OUT if cu == a else IN
                beta = BEFORE if subset[c] < subset[s] else AFTER
                far = cv if cu == a else cu
                far_end = 1 if cu == a else 0
                deps[s].append(Dependency(child=c, meet_end=meet_end,
                                          alpha=alpha, beta=beta,
                                          child_far_end=far_end))
                vsource[far] = (c, far_end)
                nxt.append(c)
        frontier = nxt
    if len(visited) != k:
        raise AssertionError("BFS over tree edges did not reach all edges")

    height = [0] * k
    order = _topo_by_height(parent, deps, root, k)
    for s in order:  # leaves first
        if deps[s]:
            height[s] = 1 + max(height[d.child] for d in deps[s])
    topo_down = tuple(reversed(order))
    vertex_source = tuple(vsource[v] for v in range(motif.num_vertices))
    return SpanningTree(motif=motif, edge_ids=tuple(subset), root=root,
                        parent=tuple(parent),
                        deps=tuple(tuple(d) for d in deps),
                        height=tuple(height), topo_down=topo_down,
                        vertex_source=vertex_source)


def _topo_by_height(parent, deps, root, k) -> list[int]:
    """Children-before-parents order (weight DP order)."""
    out: list[int] = []
    seen: set[int] = set()

    def visit(s: int) -> None:
        for d in deps[s]:
            visit(d.child)
        seen.add(s)
        out.append(s)

    visit(root)
    assert len(out) == k
    return out


def constraint_looseness(motif: TemporalMotif, subset: tuple[int, ...]) -> int:
    """Alg. 8: sum over vertices of |rank gap - 1| for adjacent tree-edge pairs.

    Lower is tighter ordering (preferred).  Root-independent.
    """
    total = 0
    for u in range(motif.num_vertices):
        inc = [eid for eid in subset if u in motif.edges[eid]]
        if len(inc) < 2:
            continue
        for e1, e2 in itertools.combinations(inc, 2):
            total += abs(abs(e1 - e2) - 1)
    return total


def candidate_trees(motif: TemporalMotif, n_candidates: int = 4,
                    roots_per_tree: int = 2) -> list[SpanningTree]:
    """Alg. 7 steps 1-3: enumerate, rank by looseness, emit rooted candidates.

    Root heuristic: (a) the tree edge with the median pi-rank (temporal windows
    then branch both directions, keeping chained-window slack small) and (b)
    the edge minimising rooted height (shortest DP dependency chains).
    """
    subsets = tree_edge_subsets(motif)
    subsets.sort(key=lambda s: (constraint_looseness(motif, s), s))
    cands: list[SpanningTree] = []
    for subset in subsets[:n_candidates]:
        ranked = sorted(subset)
        roots = [ranked[len(ranked) // 2]]
        if roots_per_tree > 1:
            best = None
            for r in subset:
                t = build_tree(motif, subset, r)
                h = max(t.height)
                if best is None or h < best[0]:
                    best = (h, r)
            if best is not None and best[1] not in roots:
                roots.append(best[1])
        for r in roots[:roots_per_tree]:
            cands.append(build_tree(motif, subset, r))
    return cands


def all_rooted_trees(motif: TemporalMotif) -> list[SpanningTree]:
    """Every (spanning tree x root edge) candidate — for Fig. 6 style sweeps."""
    out = []
    for subset in tree_edge_subsets(motif):
        for r in subset:
            out.append(build_tree(motif, subset, r))
    return out

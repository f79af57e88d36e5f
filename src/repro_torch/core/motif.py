"""Temporal motif definitions (paper Def. 1.1) and the evaluation motif library.

The port's own copy of ``repro.core.motif`` (same catalog, same DSL).

A temporal motif is ``M = (H, pi, delta)``: a directed (multi)pattern-graph H,
a total order ``pi`` over its edges, and a time window ``delta``.  We represent
H + pi jointly: ``edges[r]`` is the motif edge with pi-rank ``r`` (rank ==
position).  ``delta`` is supplied at estimation time so the same structural
motif can be counted under different windows (as in the paper's evaluation).
"""
from __future__ import annotations

import itertools
import re
from dataclasses import dataclass


@dataclass(frozen=True)
class TemporalMotif:
    """A directed temporal pattern: ``edges`` listed in pi (time) order."""

    name: str
    num_vertices: int
    edges: tuple[tuple[int, int], ...]  # (src, dst) vertex ids, pi order = index

    def __post_init__(self) -> None:
        if self.num_vertices < 2:
            raise ValueError("motif needs >= 2 vertices")
        seen: set[int] = set()
        for (u, v) in self.edges:
            if u == v:
                raise ValueError(f"{self.name}: self-loop {u}->{v} not allowed")
            if not (0 <= u < self.num_vertices and 0 <= v < self.num_vertices):
                raise ValueError(f"{self.name}: vertex id out of range")
            seen.update((u, v))
        if seen != set(range(self.num_vertices)):
            raise ValueError(f"{self.name}: isolated vertices present")
        if not self._connected():
            raise ValueError(f"{self.name}: motif must be (weakly) connected")

    # -- helpers ---------------------------------------------------------
    @property
    def num_edges(self) -> int:
        return len(self.edges)

    def _connected(self) -> bool:
        adj: dict[int, set[int]] = {v: set() for v in range(self.num_vertices)}
        for (u, v) in self.edges:
            adj[u].add(v)
            adj[v].add(u)
        seen = {0}
        stack = [0]
        while stack:
            x = stack.pop()
            for y in adj[x]:
                if y not in seen:
                    seen.add(y)
                    stack.append(y)
        return len(seen) == self.num_vertices

    def rank_of(self, edge_id: int) -> int:
        """pi-rank of a motif edge (identity: edges are stored in pi order)."""
        return edge_id

    def undirected_pairs(self) -> list[frozenset[int]]:
        return [frozenset((u, v)) for (u, v) in self.edges]


def _m(name: str, n: int, *edges: tuple[int, int]) -> TemporalMotif:
    return TemporalMotif(name=name, num_vertices=n, edges=tuple(edges))


# ---------------------------------------------------------------------------
# Motif library — the paper's evaluation motifs (Figures 1 and 3).
#
# Figure 3 is not machine-readable in the provided text; the topologies below
# follow the paper's explicit descriptions (M5-5 = 5-clique, M6-5 = 6-clique,
# M5-3 per Figure 5, cycles per Figure 1b/1c, scatter-gather/bipartite per
# Figure 1d/1e) and standard choices from this literature (Paranjape et al.)
# for the remaining star/path/tailed variants.  All orderings (pi) are the
# canonical "edge label = temporal rank" orderings used throughout the paper.
# ---------------------------------------------------------------------------

def _clique(name: str, n: int) -> TemporalMotif:
    """Temporal n-clique: all ordered pairs (i<j) as i->j, pi = lexicographic."""
    edges = [(i, j) for i, j in itertools.combinations(range(n), 2)]
    return _m(name, n, *edges)


def _cycle(name: str, n: int) -> TemporalMotif:
    """Temporal simple n-cycle (Fig 1b/1c): 0->1->...->0 in time order."""
    edges = [(i, (i + 1) % n) for i in range(n)]
    return _m(name, n, *edges)


def _path(name: str, n: int) -> TemporalMotif:
    edges = [(i, i + 1) for i in range(n - 1)]
    return _m(name, n, *edges)


def _out_star(name: str, n: int) -> TemporalMotif:
    edges = [(0, i) for i in range(1, n)]
    return _m(name, n, *edges)


MOTIFS: dict[str, TemporalMotif] = {}


def register(m: TemporalMotif) -> TemporalMotif:
    MOTIFS[m.name] = m
    return m


# ---- 4-vertex motifs (Table 5) -------------------------------------------
register(_path("M4-1", 4))                                   # temporal 4-path
register(_out_star("M4-2", 4))                               # out-star
register(_cycle("M4-3", 4))                                  # 4-cycle
register(_m("M4-4", 4, (0, 1), (1, 2), (2, 0), (2, 3)))      # tailed triangle
register(_m("M4-5", 4, (0, 1), (0, 2), (0, 3), (1, 2)))      # star + chord
register(_m("M4-7", 4, (0, 1), (1, 2), (2, 3), (3, 0)))      # 4-cycle variant
# (M4-7 uses the rectangle orientation with pi along the cycle; M4-3 ditto but
#  is kept separate so Table-5 rows have stable names.)

# ---- 5-vertex motifs (Figure 3 row 1) -------------------------------------
register(_out_star("M5-1", 5))
register(_path("M5-2", 5))
register(_cycle("M5-3", 5))                                  # Fig 1b money cycle
register(_m("M5-4", 5,                                        # dense: K4 + tail
            (0, 1), (0, 2), (1, 2), (0, 3), (1, 3), (2, 3), (3, 4)))
register(_clique("M5-5", 5))                                 # 5-clique

# ---- 6-vertex motifs (Figure 3 row 2) -------------------------------------
register(_out_star("M6-1", 6))
register(_m("M6-2", 6,                                        # scatter-gather
            (0, 1), (0, 2), (0, 3), (1, 4), (2, 4), (3, 4), (4, 5)))
register(_cycle("M6-3", 6))                                  # Fig 1c money cycle
register(_m("M6-4", 6,                                        # dense core + spokes
            (0, 1), (1, 2), (2, 0), (2, 3), (3, 4), (4, 2), (4, 5), (5, 0)))
register(_clique("M6-5", 6))                                 # 6-clique

# ---- Figure 1 money-laundering motifs --------------------------------------
register(_m("scatter-gather", 5,                              # Fig 1d
            (0, 1), (0, 2), (0, 3), (1, 4), (2, 4), (3, 4)))
register(_m("bipartite", 5,                                   # Fig 1e: 2x3 layering
            (0, 2), (0, 3), (0, 4), (1, 2), (1, 3), (1, 4)))

# small motifs for unit tests
register(_m("wedge", 3, (0, 1), (1, 2)))
register(_m("triangle", 3, (0, 1), (1, 2), (2, 0)))
register(_m("diamond", 4, (0, 1), (0, 2), (1, 3), (2, 3)))
register(_m("edge2", 2, (0, 1), (0, 1)))                      # temporal multi-edge
register(_m("ping-pong", 2, (0, 1), (1, 0)))


# ---------------------------------------------------------------------------
# Inline edge-list DSL: "0-1,1-2,2-0" = directed edges u->v in pi order.
# Lets CLIs / serve requests express custom motifs without touching the
# catalog above.  Vertex ids must be 0..n-1 (n inferred as max id + 1);
# all TemporalMotif validation (connectivity, no self-loops, no isolated
# vertices) applies.
# ---------------------------------------------------------------------------
_SPEC_RE = re.compile(r"^\s*\d+\s*-\s*\d+\s*(,\s*\d+\s*-\s*\d+\s*)*$")


def is_motif_spec(name: str) -> bool:
    """True when ``name`` is an inline edge-list spec, not a catalog name
    (catalog names like "M5-3" or "scatter-gather" never match: both
    endpoints of every pair must be bare integers)."""
    return bool(_SPEC_RE.match(name))


def parse_motif_spec(spec: str) -> TemporalMotif:
    """Build a ``TemporalMotif`` from an inline "u-v,u-v,..." spec.

    The motif's ``name`` is the canonical re-serialization
    (``motif_spec`` of the result round-trips to it).
    """
    if not is_motif_spec(spec):
        raise ValueError(f"not a motif edge-list spec: {spec!r} "
                         "(want e.g. '0-1,1-2,2-0')")
    edges = []
    for part in spec.split(","):
        u, _, v = part.partition("-")
        edges.append((int(u), int(v)))
    n = 1 + max(max(u, v) for u, v in edges)
    return TemporalMotif(name=",".join(f"{u}-{v}" for u, v in edges),
                         num_vertices=n, edges=tuple(edges))


def motif_spec(motif: TemporalMotif) -> str:
    """Serialize any motif to the inline DSL (``parse_motif_spec``
    round-trips: same vertices, same edges, same pi order)."""
    return ",".join(f"{u}-{v}" for u, v in motif.edges)


def get_motif(name: str) -> TemporalMotif:
    """Catalog lookup, or inline DSL parse when ``name`` looks like one
    ("0-1,1-2,2-0"); catalog names always win (none parse as specs)."""
    try:
        return MOTIFS[name]
    except KeyError as e:
        if is_motif_spec(name):
            return parse_motif_spec(name)
        raise KeyError(f"unknown motif {name!r}; have {sorted(MOTIFS)}") from e

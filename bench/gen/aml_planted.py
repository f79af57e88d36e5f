"""A bank's transaction ledger with planted laundering, after AMLworld.

Background: transfers between accounts drawn with Chung-Lu power-law
weights (``alpha``), at uniform whole seconds over the span; a share
``multiplicity`` repeats an earlier pair a geometric gap
(``repeat_gap_p``) later, as standing payments do.  Planted: one
transaction in ``laundering_one_in`` belongs to a laundering pattern,
the patterns' edges split about evenly between 5-account cycles,
6-account cycles and scatter-gathers (a source pays three mules, each
mule pays one collector, the collector pays out onward: 5 accounts, 7
edges), every pattern among distinct accounts drawn uniformly, its
edges in order at increasing seconds inside ``pattern_window_s``.
"""
from __future__ import annotations

import torch

from bench.gen.chung_lu import endpoints, first_unique, repeats

# edges of each planted pattern, over its local accounts, in time order
PATTERNS = {
    "cycle5": [(i, (i + 1) % 5) for i in range(5)],
    "cycle6": [(i, (i + 1) % 6) for i in range(6)],
    "scatter_gather": [(0, 1), (0, 2), (0, 3), (1, 4), (2, 4), (3, 4),
                       (4, 5)],
}


def _distinct_rows(count: int, width: int, n: int, gen, device):
    """``[count, width]`` account ids, distinct within every row."""
    ids = torch.randint(0, n, (count, width), generator=gen, device=device)
    for _ in range(16):
        srt = torch.sort(ids, dim=1).values
        bad = (srt[:, 1:] == srt[:, :-1]).any(dim=1)
        nbad = int(bad.sum())
        if not nbad:
            return ids
        ids[bad] = torch.randint(0, n, (nbad, width), generator=gen,
                                 device=device)
    raise RuntimeError("could not draw distinct accounts")


def pattern_counts(cfg: dict) -> dict:
    """How many of each pattern: their edges about ``edges /
    laundering_one_in``, a third to each kind."""
    budget = round(cfg["edges"] / cfg["laundering_one_in"])
    counts = {"cycle5": round(budget / 3 / 5), "cycle6": round(budget / 3 / 6)}
    counts["scatter_gather"] = round(
        (budget - 5 * counts["cycle5"] - 6 * counts["cycle6"]) / 7)
    return counts


def planted(cfg: dict, gen, device):
    """The laundering patterns' edges: ``(src, dst, t)``, pattern by
    pattern in ``PATTERNS`` order."""
    span, win = cfg["time_span_s"], cfg["pattern_window_s"]
    counts = pattern_counts(cfg)
    out = []
    for name, edges in PATTERNS.items():
        c, L = counts[name], len(edges)
        width = 1 + max(max(e) for e in edges)
        acc = _distinct_rows(c, width, cfg["vertices"], gen, device)
        u = torch.tensor([e[0] for e in edges], device=device)
        v = torch.tensor([e[1] for e in edges], device=device)
        start = torch.randint(0, span - win, (c, 1), generator=gen,
                              device=device)
        gaps = torch.randint(1, win // L + 1, (c, L), generator=gen,
                             device=device)
        t = start + torch.cumsum(gaps, dim=1) - gaps[:, :1]
        out.append((acc[:, u].flatten(), acc[:, v].flatten(), t.flatten()))
    return tuple(torch.cat(x) for x in zip(*out))


def generate(cfg: dict, seed: int, device):
    """``(src, dst, t)`` int64 on ``device``: exactly ``cfg["edges"]``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    m, span = cfg["edges"], cfg["time_span_s"]
    bad = planted(cfg, gen, device)
    n_rep = round(m * cfg["multiplicity"])
    n_base = m - n_rep - bad[0].numel()
    draw = int(n_base * 1.05) + 1000
    src = endpoints(cfg["vertices"], cfg["alpha"], draw, gen, device)
    dst = endpoints(cfg["vertices"], cfg["alpha"], draw, gen, device)
    t = torch.randint(0, span + 1, (draw,), generator=gen, device=device)
    rep = repeats(src, dst, t, int(n_rep * 1.05) + 1000,
                  cfg["repeat_gap_p"], span, gen)
    s, d, tt = first_unique([bad, (src, dst, t), rep],
                            [bad[0].numel(), n_base, n_rep])
    return s, d, tt

"""Each generator is deterministic in the seed and meets its
configuration's counts (checked at 1/400 of the scale, the counts then
as the configuration states them)."""
import pytest
import torch

from bench import run as harness
from bench.gen.aml_planted import PATTERNS
from bench.tests import small

PUBLISHED = {"wikitalk": dict(vertices=1140149, edges=7833140,
                              pairs=3309592, time_span_s=200448000),
             "aml-hi-small": dict(vertices=515080, edges=5078345,
                                  time_span_s=864000)}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_configuration_states_its_source_counts(name):
    cfg = harness.load_json("configs", name)
    assert {k: cfg[k] for k in PUBLISHED[name]} == PUBLISHED[name]
    assert cfg["reduced"] == [] and cfg["assumed"]


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_generator_is_deterministic_and_meets_counts(name):
    cfg = small.config(name)
    gen = harness.plugin("gen", cfg["generator"])
    a = gen.generate(cfg, 2**31 + 5, "cpu")
    b = gen.generate(cfg, 2**31 + 5, "cpu")
    c = gen.generate(cfg, 2**31 + 6, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[2], c[2])
    src, dst, t = a
    assert src.numel() == dst.numel() == t.numel() == cfg["edges"]
    assert bool((src != dst).all())
    assert 0 <= int(src.min()) and int(max(src.max(), dst.max())) < cfg[
        "vertices"]
    assert 0 <= int(t.min()) and int(t.max()) <= cfg["time_span_s"]
    key = torch.stack([src, dst, t], 1)
    assert torch.unique(key, dim=0).shape[0] == cfg["edges"]
    if "pairs" in cfg:
        pairs = torch.unique(torch.stack([src, dst], 1), dim=0)
        assert pairs.shape[0] == cfg["pairs"]
        touched = torch.unique(torch.cat([src, dst]))
        assert touched.numel() == cfg["vertices"]


def test_laundering_patterns_are_planted_in_order():
    cfg = dict(small.config("aml-hi-small"), edges=500_000)
    gen = harness.plugin("gen", "aml_planted")
    counts = gen.pattern_counts(cfg)
    src, dst, t = gen.planted(cfg, torch.Generator().manual_seed(3), "cpu")
    assert abs(src.numel() - cfg["edges"] / cfg["laundering_one_in"]) <= 7
    at = 0
    for name, edges in PATTERNS.items():
        n, L = counts[name], len(edges)
        assert n > 0
        rows = slice(at, at + n * L)
        s, d, tt = (x[rows].view(n, L) for x in (src, dst, t))
        assert bool((tt.diff(dim=1) > 0).all())
        assert int((tt[:, -1] - tt[:, 0]).max()) < cfg["pattern_window_s"]
        # the pattern's own shape, over distinct accounts
        local = {}
        for j, (u, v) in enumerate(edges):
            for a, col in ((u, s[:, j]), (v, d[:, j])):
                assert torch.equal(local.setdefault(a, col), col)
        acc = torch.stack([local[a] for a in sorted(local)], 1)
        srt = torch.sort(acc, 1).values
        assert bool((srt[:, 1:] != srt[:, :-1]).all())
        at += n * L
    assert at == src.numel()


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_seeds_relabel_one_draw(name):
    """Every seed serves the generator's one draw up to isomorphism:
    the same times and degree sequence and the same plans, in other
    arrays."""
    from bench.reference.estimate import Reference
    cfg = small.config(name)
    loop = harness.plugin("loops", "session_batches")
    a = loop.make_edges(harness.plugin, cfg, 2**31 + 1, "cpu")
    b = loop.make_edges(harness.plugin, cfg, 2**31 + 2, "cpu")
    again = loop.make_edges(harness.plugin, cfg, 2**31 + 1, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, again))
    assert torch.equal(a[2], b[2]) and not torch.equal(a[0], b[0])

    def degrees(src):
        return torch.sort(torch.bincount(src, minlength=cfg["vertices"])
                          ).values
    assert torch.equal(degrees(a[0]), degrees(b[0]))
    ra, rb = Reference(*a), Reference(*b)
    for motif in ("M4-4", "M5-3"):
        (ta, wa), (tb, wb) = (r.plan(motif, small.DELTA[name])
                              for r in (ra, rb))
        assert ta.edges == tb.edges and wa.W == wb.W > 0

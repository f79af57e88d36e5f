"""The plain reference answers as the program does, on small graphs from
both configurations' generators: the index ``from_edges`` builds, each
plan's tree and ``W``, the six sums and the estimate of each motif of
both mixes (the program on the CPU, through its plain twins)."""
import pytest

import repro_torch
from repro_torch.core.graph import TemporalGraph

from bench import run as harness
from bench.reference.estimate import Reference
from bench.reference.graph import arrays_differing
from bench.tests import small

CASES = [("wikitalk", m) for m in harness.load_json("traffic",
                                                    "census")["motifs"]]
CASES += [("aml-hi-small", m) for m in harness.load_json(
    "traffic", "screen")["motifs"]]


@pytest.fixture(scope="module")
def graphs():
    out = {}
    for name in ("wikitalk", "aml-hi-small"):
        cfg = small.config(name)
        edges = harness.plugin("gen", cfg["generator"]).generate(
            cfg, 2**31 + 77, "cpu")
        g = TemporalGraph.from_edges(*(x.numpy() for x in edges))
        out[name] = (g, g.device_arrays("cpu"), Reference(*edges))
    return out


@pytest.mark.parametrize("name", ["wikitalk", "aml-hi-small"])
def test_index_equals_from_edges(graphs, name):
    _, dev, ref = graphs[name]
    assert arrays_differing(dev, ref.g) == []
    assert set(dev) == set(ref.g)


@pytest.mark.parametrize("name,motif", CASES)
def test_reference_equals_port_estimate(graphs, name, motif):
    g, dev, ref = graphs[name]
    delta = small.DELTA[name]
    res = repro_torch.estimate(g, motif, delta, 256, seed=2**31 + 3,
                               chunk=256, dev=dev, device="cpu")
    want, = ref.run([(motif, delta, 256, 2**31 + 3)], 256)
    assert res.W == want["W"] > 0
    assert tuple(res.tree_edges) == want["tree_edges"]
    got = dict(cnt2=res.cnt2_sum, valid=res.valid, fail_vmap=res.fail_vmap,
               fail_delta=res.fail_delta, fail_order=res.fail_order,
               overflow=res.overflow, k=res.k)
    assert got == {kk: want[kk] for kk in got}
    assert res.estimate == want["estimate"]

"""Small copies of the benchmark's cells for the CPU tests: each
configuration cut to ``edges`` (vertices, and wiki-talk's pairs and
span, cut in proportion), each mix with ``k`` and ``chunk`` cut to a
CPU's size."""
from bench import run as harness

EDGES = 4000
#: windows at which the small graphs still hold matches of every motif
DELTA = {"wikitalk": 3600, "aml-hi-small": 86400}


def config(name: str, edges: int = EDGES) -> dict:
    cfg = dict(harness.load_json("configs", name))
    scale = edges / cfg["edges"]
    cfg["vertices"] = max(64, round(cfg["vertices"] * scale))
    cfg["edges"] = edges
    if "pairs" in cfg:
        cfg["pairs"] = round(cfg["pairs"] * scale)
    if cfg["generator"] == "chung_lu":
        cfg["time_span_s"] = round(cfg["time_span_s"] * scale)
    return cfg


def traffic(name: str, **kw) -> dict:
    return {**harness.load_json("traffic", name), "k": 256, "chunk": 256,
            **kw}


CELLS = {"wikitalk.census": ("wikitalk", "census"),
         "aml-hi-small.screen": ("aml-hi-small", "screen")}


def run(cell: str, seed: int = 2**31 + 11, **mix_kw) -> dict:
    cfg, mix = CELLS[cell]
    return harness.run(cell, seed, 0.1, False, device="cpu",
                       config=config(cfg), traffic=traffic(mix, **mix_kw),
                       forbid=())

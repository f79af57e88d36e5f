"""``BENCHMARK.json`` keeps the contract's shape, and everything it names
resolves by name under ``bench/``."""
import json
import re
from pathlib import Path

import pytest

from bench import run as harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert (ROOT / BENCH["command"][1]).is_file()
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the check's 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        names.add(c["name"])
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    assert all(any(w["config"] == c for w in BENCH["workloads"])
               for c in names)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    for x in [*BENCH["configs"], *BENCH["workloads"], *metrics]:
        assert NAME.match(x["name"]), x["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_by_name(cell):
    _, cfg, mix, e2e, layer = harness.resolve(BENCH, cell)
    entry = next(c for c in BENCH["configs"]
                 if c["name"] == next(w["config"] for w in BENCH["workloads"]
                                      if w["name"] == cell))
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    assert cfg["source"] == entry["source"]
    assert hasattr(harness.plugin("gen", cfg["generator"]), "generate")
    loop = harness.plugin("loops", mix["loop"])
    assert all(hasattr(loop, f) for f in ("setup", "window", "check",
                                          "summary"))
    assert {"setup_s"} <= {m["name"] for m in e2e} and layer
    for m in e2e + layer:
        assert callable(harness.plugin("metrics", m["name"]).read)


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        harness.resolve(BENCH, "no-such-cell")
    with pytest.raises(FileNotFoundError):
        harness.plugin("metrics", "no_such_metric")

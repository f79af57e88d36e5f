"""What the benchmark loads: in a fresh interpreter, ``bench/run.py``'s
modules (its loop, generators and metric readers with them) and every
module of ``bench/reference`` leave no module named ``jax`` or
``repro`` loaded, and the reference none of ``repro_torch``.  Names are
compared whole at their first dot, since ``repro_torch`` begins with
``repro``."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

_REFERENCE = """
import importlib, json, pkgutil, sys
sys.path[:0] = [{root!r}]
import bench.reference as r
names = [m.name for m in pkgutil.walk_packages(r.__path__, "bench.reference.")]
for n in names:
    importlib.import_module(n)
import bench.yardstick.bytes
print(json.dumps(dict(names=names, top=sorted({{m.split(".", 1)[0]
                                               for m in sys.modules}}))))
"""

_HARNESS = """
import json, sys
sys.path[:0] = [{root!r} + "/src", {root!r}]
from bench import run
bench = json.loads(open({root!r} + "/BENCHMARK.json").read())
for cell in bench["workloads"]:
    _, cfg, mix, e2e, layer = run.resolve(bench, cell["name"])
    run.plugin("gen", cfg["generator"])
    loop = run.plugin("loops", mix["loop"])
    for m in e2e + layer:
        run.plugin("metrics", m["name"])
import repro_torch.api, repro_torch.core.graph, repro_torch.core.engine
import bench.control, bench.yardstick.trace
top = sorted({{m.split(".", 1)[0] for m in sys.modules}})
print(json.dumps(dict(top=top)))
"""


def _top_level(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT / "bench"))
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_imports_nothing_of_the_program_or_jax():
    got = _top_level(_REFERENCE)
    assert len(got["names"]) >= 8
    assert not {"jax", "jaxlib", "flax", "repro", "repro_torch"} & set(
        got["top"])


def test_harness_loads_neither_jax_nor_the_jax_package():
    top = set(_top_level(_HARNESS)["top"])
    assert "repro_torch" in top and "bench" in top
    assert not {"jax", "jaxlib", "flax", "repro"} & top

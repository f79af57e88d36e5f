#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell
asks for.  The cell is an entry of ``BENCHMARK.json``'s ``workloads``;
everything else is found by name under ``bench/``: its configuration
(``configs/<config>.json``, whose ``generator`` names ``gen/<name>.py``),
its traffic mix (``traffic/<traffic>.json``, whose ``loop`` names
``loops/<name>.py``) and each metric (``metrics/<metric>.py``).

A run: set-up (the loop's: data from ``--seed``, the program's state,
warm-up of the cell's own shapes), the measured window of ``--seconds``,
then the check against the plain reference (``bench/reference/``) once
the window has closed and the memory peak has been read.  With
``--trace 1`` the program's spans are recorded over the window, one
slice of it runs under the profiler, and the metrics are the cell's
per-layer ones.  The last line of standard output is the result; the
last lines of standard error are the numbers compared, each beside its
limit.  Without the card(s), or if a module of JAX or of the JAX
package has been loaded, it exits with an error and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
CACHE = ROOT / "build" / "bench"
#: top-level modules that must not be loaded in the measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _fixed_caches() -> None:
    """The CUDA JIT cache (``CUDA_CACHE_PATH``) at a fixed path inside the
    checkout (the program builds its own kernels under
    ``build/repro_torch``)."""
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")


def plugin(kind: str, name: str):
    """The module ``bench/<kind>/<name>.py``."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    safe = "".join(c if c.isalnum() else "_" for c in name)
    mod_name = f"bench.{kind}._{safe}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    return json.loads(path.read_text())


def resolve(bench: dict, workload: str) -> tuple:
    """``(cell, config, traffic, end_to_end, per_layer)`` of a cell:
    the metric entries are those that name the cell or no cells."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    return (cell, load_json("configs", cell["config"]),
            load_json("traffic", cell["traffic"]),
            mine(bench["end_to_end"]), mine(bench["per_layer"]))


def forbidden_loaded(forbid=FORBIDDEN) -> list:
    """The loaded top-level modules among ``forbid``, compared whole
    (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(forbid))


class Ctx:
    """What one run knows: its arguments, the loop's state and what it
    measured; the metric readers read it."""

    def __init__(self, cell, config, traffic, seed, seconds, trace, device):
        import torch
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace = int(seed), seconds, bool(trace)
        self.device = torch.device(device)
        self.slice = None

    def plugin(self, kind, name):
        return plugin(kind, name)

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def log(self, **kw) -> None:
        print(json.dumps(kw, default=str), file=sys.stderr, flush=True)

    def profile(self, fn):
        from bench.yardstick import trace
        return trace.capture(fn)

    def spans(self) -> list:
        """The recorded host spans ``(t0_s, dur_s, name, attrs)``."""
        from repro_torch import obs
        return [(r["t0"], r["dur_s"], r["name"], r.get("attrs", {}))
                for r in obs.RECORDER.records() if "dur_s" in r]


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", bench: dict | None = None,
        config: dict | None = None, traffic: dict | None = None,
        t_start: float | None = None, forbid=FORBIDDEN) -> dict:
    """One run of a cell; returns the result line as a dict.

    ``config`` / ``traffic`` replace the cell's files (the harness's own
    tests run small cells on the CPU this way); ``setup_s`` counts from
    ``t_start`` (default: the call); a module of ``forbid`` loaded
    once the window has closed ends the run."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, cfg, mix, e2e, layer = resolve(bench, workload)
    ctx = Ctx(cell, config or cfg, traffic or mix, seed, seconds, trace,
              device)
    loop = plugin("loops", ctx.traffic["loop"])
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    if trace:
        from bench.yardstick import trace as tr
        tr.warm_up()
    loop.setup(ctx)
    ctx.sync()
    ctx.setup_s = time.perf_counter() - t_start
    loop.window(ctx)
    ctx.sync()
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    bad = forbidden_loaded(forbid)
    if bad:
        raise SystemExit(f"bench: modules {bad} are loaded in the measured "
                         "process")
    counts = loop.summary(ctx)
    loop.check(ctx)
    metrics = {}
    for m in (layer if trace else e2e):
        value = plugin("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(ctx.device)
                    if ctx.device.type == "cuda" else "cpu"),
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if ctx.device.type == "cuda":
        dev["name_and_power_limit"] = power_limit()
    out = {"correct": all(v <= lim for v, lim in ctx.checks.values()),
           "attempted": counts["attempted"], "failed": counts["failed"],
           "metrics": metrics, "device": dev}
    if trace and ctx.slice is not None:
        dev["busy_s"] = ctx.slice.busy_s
        dev["window_s"] = ctx.slice.wall_s
        out["breakdown"] = {
            "device_ops": ctx.slice.device_ops(),
            "idle_gaps": ctx.slice.idle_gaps(
                [(t0, d, n) for t0, d, n, _ in ctx.spans()])}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in ctx.checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fixed_caches()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = resolve(bench, args.workload)[0]
    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"bench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace),
              bench=bench, t_start=T_START)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

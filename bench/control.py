#!/usr/bin/env python3
"""The control of ``correct``: the reference in float32 in the program's
place.

    python3 bench/control.py --workload <cell> --seed <n> [<n> ...]

For each seed: the cell's data and its first measured batch, as a run
of ``bench/run.py`` makes them; the reference with the weights in
float32 (the TPU kernels' precision below 2^24) answers the batch, and
the answers are compared with the exact reference's as a run compares
the program's.  A sound comparison reads disagreements here: every
limit is 0.  Also prints the exact reference's time for the batch.
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control(cell: str, seed: int, device: str = "cuda", config=None,
            traffic=None) -> dict:
    """Disagreements of the float32 reference with the exact one on the
    cell's first measured batch at ``seed``."""
    import torch

    from bench import run as harness
    from bench.reference.check import compare
    from bench.reference.estimate import Reference

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    _, cfg, mix, _, _ = harness.resolve(bench, cell)
    cfg, mix = config or cfg, traffic or mix
    loop = harness.plugin("loops", mix["loop"])
    edges = loop.make_edges(harness.plugin, cfg, seed, torch.device(device))
    reqs = loop.requests_of(
        mix, loop.batch_seeds(seed, loop.WARMUP_BATCHES + 1)[-1])
    t0 = time.perf_counter()
    want = Reference(*edges).run(reqs, int(mix["chunk"]))
    exact_s = time.perf_counter() - t0
    got = Reference(*edges, dtype=torch.float32).run(reqs, int(mix["chunk"]))
    bad = compare(got, want)
    return dict(seed=seed, exact_reference_s=exact_s, **bad,
                W_exact=[w["W"] for w in want], W_f32=[g["W"] for g in got])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    for seed in args.seed:
        print(json.dumps(control(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

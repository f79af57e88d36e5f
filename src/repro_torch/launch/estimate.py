"""One-shot TIMEST estimate from the command line.

    PYTHONPATH=src python -m repro_torch.launch.estimate \\
        --graph powerlaw:n=150,m=2000,time_span=40000,seed=11 \\
        --motif M5-3 --delta 3000 --k 1024 --chunk 256 --device cpu

Runs on the card by default (``--device cuda``) and fails without one.
Prints the same ``summary()`` and ``fail:`` lines as the JAX package's
``repro.launch.estimate``.  Graphs: ``powerlaw:...`` / ``er:...`` /
``fintxn:...`` synthetic specs.  ``--motif`` takes catalog names or
inline edge-list specs such as ``0-1,1-2,2-0``.
"""
from __future__ import annotations

import argparse

from ..core.estimator import estimate
from ..core.motif import get_motif
from ..graphs import (er_temporal_graph, fintxn_temporal_graph,
                      powerlaw_temporal_graph)


def parse_graph(spec: str):
    """``kind:key=value,...`` -> a synthetic ``TemporalGraph``."""
    kind, _, args = spec.partition(":")
    kw = {}
    for item in args.split(","):
        if item:
            k, _, v = item.partition("=")
            kw[k] = float(v) if "." in v else int(v)
    fns = dict(powerlaw=powerlaw_temporal_graph, er=er_temporal_graph,
               fintxn=fintxn_temporal_graph)
    if kind not in fns:
        raise SystemExit(f"unknown graph kind {kind!r}; have {sorted(fns)}")
    return fns[kind](**kw)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph", default="powerlaw:n=500,m=8000")
    ap.add_argument("--motif", default="M5-3")
    ap.add_argument("--delta", type=int, default=5000)
    ap.add_argument("--k", type=int, default=1 << 18)
    ap.add_argument("--chunk", type=int, default=1 << 13)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the hand-written kernels) or cpu "
                         "(their plain torch versions)")
    args = ap.parse_args(argv)

    g = parse_graph(args.graph)
    print(f"graph: n={g.n} m={g.m} span={g.time_span}  "
          f"motif={args.motif} delta={args.delta}  k={args.k}  "
          f"device={args.device}")
    res = estimate(g, get_motif(args.motif), args.delta, args.k,
                   seed=args.seed, chunk=args.chunk, device=args.device)
    print(res.summary())
    print(f"  fail: vmap={res.fail_vmap} delta={res.fail_delta} "
          f"order={res.fail_order} overflow={res.overflow}  "
          f"device={args.device}")


if __name__ == "__main__":
    main()

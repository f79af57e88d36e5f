"""TIMEST estimation from the command line.

    PYTHONPATH=src python -m repro_torch.launch.estimate \\
        --graph powerlaw:n=150,m=2000,time_span=40000,seed=11 \\
        --motif M5-3 --delta 3000 --k 1024 --chunk 256 --device cpu

Runs on the card by default (``--device cuda``) and fails without one.
Prints the same ``summary()`` and ``fail:`` lines as the JAX package's
``repro.launch.estimate``.  Graphs: ``powerlaw:...`` / ``er:...`` /
``fintxn:...`` synthetic specs, or a path to an edge-list file (text,
``.gz`` text or ``.npz``).  ``--motif`` takes catalog names or inline
edge-list specs such as ``0-1,1-2,2-0``.

Comma lists in ``--motif`` / ``--delta`` fan out into their cross
product and run through ``estimate_many`` (jobs sharing a tree
signature fuse into one tree cohort).  ``--checkpoint FILE`` writes the
reference's checkpoint JSON after every window and resumes from it;
``--exact`` also runs the exact oracle (slow) and prints the error.

Serving: ``--serve`` keeps ONE resident session and answers NDJSON
requests on stdin with NDJSON responses on stdout (logs on stderr; the
protocol is ``repro_torch.api.serve``):

    printf '%s\\n' '{"id":1,"motif":"M5-3","delta":3000,"k":1024}' \\
      | PYTHONPATH=src python -m repro_torch.launch.estimate \\
          --graph powerlaw:n=150,m=2000,time_span=40000,seed=11 \\
          --serve --chunk 256 --device cpu
"""
from __future__ import annotations

import argparse
import sys

from ..core.motif import get_motif, is_motif_spec
from ..graphs import (er_temporal_graph, fintxn_temporal_graph,
                      load_edge_list, powerlaw_temporal_graph)


def parse_graph(spec: str):
    """``kind:key=value,...`` -> a synthetic ``TemporalGraph``; any other
    string is an edge-list path (``load_edge_list``)."""
    if ":" not in spec:
        return load_edge_list(spec)
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


def _print_exact(g, res, cache: dict) -> None:
    from ..core.exact import count_exact
    key = (res.motif, res.delta)
    if key not in cache:
        cache[key] = count_exact(g, get_motif(res.motif), res.delta)
    c = cache[key]
    err = abs(res.estimate - c) / max(c, 1)
    print(f"  exact={c}  error={100 * err:.2f}%")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph", default="powerlaw:n=500,m=8000")
    ap.add_argument("--motif", default="M5-3",
                    help="motif name, or comma list for batched runs")
    ap.add_argument("--delta", default="5000",
                    help="window, or comma list for batched runs")
    ap.add_argument("--k", type=int, default=1 << 18)
    ap.add_argument("--chunk", type=int, default=1 << 13)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint file: written after every window, "
                         "resumed from when it matches the job")
    ap.add_argument("--exact", action="store_true",
                    help="also run the exact oracle (slow!)")
    ap.add_argument("--serve", action="store_true",
                    help="answer NDJSON requests on stdin against one "
                         "resident session (repro_torch.api.serve)")
    ap.add_argument("--coalesce-window", type=float, default=0.05,
                    help="serve: seconds a submit window stays open so "
                         "concurrent requests can fuse")
    ap.add_argument("--coalesce-max", type=int, default=64,
                    help="serve: max requests per submit window")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the hand-written kernels) or cpu "
                         "(their plain torch versions)")
    args = ap.parse_args(argv)

    from ..api import EstimateConfig
    g = parse_graph(args.graph)

    if args.serve:
        from ..api import Session, serve_loop
        cfg = EstimateConfig(chunk=args.chunk, seed=args.seed,
                             coalesce_window_s=args.coalesce_window,
                             coalesce_max_requests=args.coalesce_max,
                             device=args.device)
        session = Session(g, cfg)
        # stdout is the response stream: logs go to stderr
        print(f"serving graph n={g.n} m={g.m} span={g.time_span}  "
              f"device={args.device}  window={args.coalesce_window}s "
              f"max={args.coalesce_max}", file=sys.stderr, flush=True)
        served = serve_loop(session)
        print(f"served {served} requests", file=sys.stderr)
        return

    # an inline motif spec contains commas itself: a --motif that parses
    # as ONE spec is a single motif, not a comma list
    motifs = ([args.motif] if is_motif_spec(args.motif)
              else args.motif.split(","))
    deltas = [int(d) for d in str(args.delta).split(",")]
    print(f"graph: n={g.n} m={g.m} span={g.time_span}  "
          f"motifs={motifs} deltas={deltas}  k={args.k}  "
          f"device={args.device}")
    exact_cache: dict = {}

    if len(motifs) > 1 or len(deltas) > 1:
        if args.checkpoint:
            raise SystemExit("--checkpoint is per-job and not supported in "
                             "batched mode yet; run jobs singly to resume")
        from ..core.batch import estimate_many
        jobs = [(m, d, args.k) for m in motifs for d in deltas]
        for res in estimate_many(g, jobs, seed=args.seed, chunk=args.chunk,
                                 device=args.device):
            print(f"delta={res.delta}  fused={res.fused_jobs}  "
                  f"{res.summary()}")
            if args.exact:
                _print_exact(g, res, exact_cache)
        return

    from ..core.estimator import estimate
    res = estimate(g, get_motif(motifs[0]), deltas[0], args.k,
                   seed=args.seed, chunk=args.chunk,
                   checkpoint_path=args.checkpoint, device=args.device)
    print(res.summary())
    print(f"  fail: vmap={res.fail_vmap} delta={res.fail_delta} "
          f"order={res.fail_order} overflow={res.overflow}  "
          f"device={args.device}")
    if args.exact:
        _print_exact(g, res, exact_cache)


if __name__ == "__main__":
    main()

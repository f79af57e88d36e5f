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

Live streams: ``--serve --stream`` starts on an EMPTY graph and takes
the ``subscribe`` / ``ingest`` / ``advance`` / ``unsubscribe`` verbs
(``--graph`` is ignored); ``--wal PATH`` logs the ingest/advance history
and recovers it on restart; ``--horizon`` is the sliding retention.
``--stream-replay FILE`` replays an edge-list file as a stream in
``--replay-batch`` batches, advancing an epoch every ``--advance-every``
batches and re-estimating the ``--motif`` x ``--delta`` standing queries
per epoch.

Multi-tenant serving: ``--serve --gateway`` pools graph and stream
tenants behind the ``open_tenant`` / ``close_tenant`` verbs
(``repro_torch.gateway``; ``--graph`` is ignored), ``--max-tenants`` and
``--tenant-quota`` bound the pool and each tenant's pending work, and
``--wal-dir DIR`` enables ``"wal": true`` stream tenants (one WAL per
tenant under DIR, recovered on reopen).

Data mesh: ``--mesh D`` shards every window's chunks over D shards
placed round-robin on the visible cards (``--device cpu``: all on the
CPU); ``--mesh auto`` takes one shard per visible card, or
``--devices N`` shards (the port's counterpart of the reference's
``--devices N``, which forces N virtual host devices).  Every mode takes
it (one-shot, batched, serve, stream, gateway) and the results are
bit-identical to the unsharded run; the log line's ``mesh=`` field
names the shape.

Telemetry (``repro_torch.obs``): ``--obs {off,metrics,trace}`` and
``--obs-ring N`` set the level and the flight recorder's capacity (the
reference's ``REPRO_OBS`` / ``REPRO_OBS_RING``; the port reads no
environment); ``--trace-out PATH`` writes the recorder as NDJSON when
the run ends (and implies ``trace``); ``--profile-dir DIR`` enables the
serve modes' ``profile`` verb, whose ``torch.profiler`` Chrome traces
land under DIR.
"""
from __future__ import annotations

import argparse
import sys

from .. import obs
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


def build_mesh(spec: str | None, devices: int | None, device: str):
    """``--mesh`` value -> ``EstimatorMesh`` | None: ``auto`` is one shard
    per visible card (``--devices N``: N shards), ``D`` is D shards."""
    if not spec or spec == "none":
        return None
    from .mesh import make_estimator_mesh
    shards = devices if spec == "auto" else int(spec)
    return make_estimator_mesh(shards, device=device)


def _mesh_shape(mesh):
    return None if mesh is None else mesh.shape


def _print_exact(g, res, cache: dict) -> None:
    from ..core.exact import count_exact
    key = (res.motif, res.delta)
    if key not in cache:
        cache[key] = count_exact(g, get_motif(res.motif), res.delta)
    c = cache[key]
    err = abs(res.estimate - c) / max(c, 1)
    print(f"  exact={c}  error={100 * err:.2f}%")


def main(argv=None) -> None:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.stream and not args.serve:
        ap.error("--stream requires --serve (for offline replay use "
                 "--stream-replay FILE)")
    if args.horizon is not None and not (args.stream or args.stream_replay):
        ap.error("--horizon only applies to stream modes (--serve --stream "
                 "or --stream-replay)")
    if args.wal is not None and not (args.serve and args.stream):
        ap.error("--wal requires --serve --stream (the WAL logs the live "
                 "ingest/advance history)")
    if args.gateway and not args.serve:
        ap.error("--gateway requires --serve (it is a serving mode)")
    if args.gateway and args.stream:
        ap.error("--gateway pools graph AND stream tenants itself; open "
                 "stream tenants over the wire instead of --stream")
    if args.wal_dir is not None and not args.gateway:
        ap.error("--wal-dir only applies to --serve --gateway (single-"
                 "stream serving uses --wal PATH)")
    if args.profile_dir is not None and not args.serve:
        ap.error("--profile-dir requires --serve (the 'profile' verb "
                 "arms the profiler over the wire)")
    if args.devices is not None and args.mesh != "auto":
        ap.error("--devices sets the shard count of --mesh auto")
    obs.set_level("trace" if args.trace_out else args.obs)
    obs.set_ring(args.obs_ring)
    try:
        _run(args)
    finally:
        if args.trace_out:
            with open(args.trace_out, "w") as f:
                f.write(obs.RECORDER.export_ndjson())
            print(f"trace: {obs.RECORDER.recorded} spans recorded, "
                  f"{len(obs.RECORDER)} in ring -> {args.trace_out}",
                  file=sys.stderr)


def _parser() -> argparse.ArgumentParser:
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
    ap.add_argument("--stream", action="store_true",
                    help="with --serve: start on an EMPTY live graph and "
                         "accept ingest/advance/subscribe verbs "
                         "(repro_torch.stream; --graph is ignored)")
    ap.add_argument("--stream-replay", default=None, metavar="FILE",
                    help="replay an edge-list file (text/.gz/.npz) as a "
                         "live stream: ingest in batches, advance epochs, "
                         "re-estimate the --motif x --delta standing "
                         "queries per epoch")
    ap.add_argument("--horizon", type=int, default=None,
                    help="stream: sliding retention window in time units "
                         "(edges older than newest-t minus horizon are "
                         "evicted at compaction; default: keep all)")
    ap.add_argument("--replay-batch", type=int, default=65536,
                    help="stream replay: edges per ingest batch")
    ap.add_argument("--advance-every", type=int, default=1,
                    help="stream replay: ingest batches per epoch advance")
    ap.add_argument("--wal", default=None, metavar="PATH",
                    help="with --serve --stream: crash-safe write-ahead "
                         "log; ingest/advance history is fsynced to PATH "
                         "and replayed on restart (torn tail truncated)")
    ap.add_argument("--gateway", action="store_true",
                    help="with --serve: multi-tenant gateway; pool many "
                         "graphs/streams in one process behind "
                         "open_tenant/close_tenant verbs with overlapped "
                         "drains (repro_torch.gateway; --graph is "
                         "ignored, tenants open over the wire)")
    ap.add_argument("--max-tenants", type=int, default=8,
                    help="gateway: tenant pool capacity (idle-LRU "
                         "eviction past it)")
    ap.add_argument("--tenant-quota", type=int, default=16,
                    help="gateway: max pending work items per tenant; "
                         "submits past it answer error_kind=overloaded")
    ap.add_argument("--wal-dir", default=None, metavar="DIR",
                    help="gateway: directory for per-tenant WAL files "
                         "(enables '\"wal\": true' stream tenants; paths "
                         "derive from the tenant name server-side)")
    ap.add_argument("--obs", default=obs.trace.DEFAULT_LEVEL,
                    choices=("off", "metrics", "trace"),
                    help="telemetry level: off (records nothing), metrics "
                         "(counters and stage histograms), trace (metrics "
                         "plus host-side spans in the flight recorder); "
                         "estimates are bit-identical at every level")
    ap.add_argument("--obs-ring", type=int, default=obs.trace.DEFAULT_RING,
                    metavar="N",
                    help="flight-recorder capacity in spans (the oldest "
                         "is overwritten when full)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the flight recorder as NDJSON to PATH when "
                         "the run ends (implies --obs trace)")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="serve modes: enable the 'profile' wire verb; "
                         "torch.profiler Chrome traces of the next N "
                         "engine windows land under DIR (never a path "
                         "from the wire)")
    ap.add_argument("--mesh", default=None,
                    help="shard chunks over a data mesh: 'auto' (one "
                         "shard per visible card, or --devices) or a "
                         "shard count; results are bit-identical to the "
                         "unsharded run")
    ap.add_argument("--devices", type=int, default=None,
                    help="shards of --mesh auto, placed round-robin on "
                         "the visible cards (all on the CPU with --device "
                         "cpu)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the hand-written kernels) or cpu "
                         "(their plain torch versions)")
    return ap


def _run(args) -> None:
    from ..api import EstimateConfig
    # an inline motif spec contains commas itself: a --motif that parses
    # as ONE spec is a single motif, not a comma list
    motifs = ([args.motif] if is_motif_spec(args.motif)
              else args.motif.split(","))
    deltas = [int(d) for d in str(args.delta).split(",")]
    mesh = build_mesh(args.mesh, args.devices, args.device)

    if args.serve and args.gateway:
        from ..gateway import gateway_serve_loop
        cfg = EstimateConfig(chunk=args.chunk, seed=args.seed,
                             coalesce_window_s=args.coalesce_window,
                             coalesce_max_requests=args.coalesce_max,
                             device=args.device)
        print(f"serving GATEWAY  max_tenants={args.max_tenants}  "
              f"quota={args.tenant_quota}  wal_dir={args.wal_dir}  "
              f"mesh={_mesh_shape(mesh)}  device={args.device}",
              file=sys.stderr, flush=True)
        served = gateway_serve_loop(cfg, max_tenants=args.max_tenants,
                                    quota=args.tenant_quota,
                                    wal_dir=args.wal_dir, mesh=mesh,
                                    profile_dir=args.profile_dir)
        print(f"served {served} responses", file=sys.stderr)
        return

    if args.serve and args.stream:
        from ..api import serve_loop
        from ..stream import StreamingSession, StreamStore
        # the device is checked before the WAL is opened or recovered
        cfg = EstimateConfig(chunk=args.chunk, seed=args.seed,
                             coalesce_window_s=args.coalesce_window,
                             coalesce_max_requests=args.coalesce_max,
                             device=args.device).resolve()
        if args.wal is not None:
            store = StreamStore.recover(args.wal, horizon=args.horizon)
            print(f"WAL {args.wal}: recovered epoch={store.epoch} "
                  f"buffered={store.buffered} "
                  f"ingested={store.stats.ingested}",
                  file=sys.stderr, flush=True)
            ss_kw = dict(store=store)
        else:
            ss_kw = dict(horizon=args.horizon)
        with StreamingSession(config=cfg, mesh=mesh, **ss_kw) as ss:
            print(f"serving LIVE stream  horizon={args.horizon}  "
                  f"wal={args.wal}  mesh={_mesh_shape(mesh)}  "
                  f"device={args.device}",
                  file=sys.stderr, flush=True)
            served = serve_loop(None, stream=ss,
                                profile_dir=args.profile_dir)
        print(f"served {served} responses", file=sys.stderr)
        return

    if args.stream_replay:
        from ..stream import StandingQuery, StreamingSession, replay_epochs
        cfg = EstimateConfig(chunk=args.chunk, seed=args.seed,
                             device=args.device)
        with StreamingSession(config=cfg, horizon=args.horizon,
                              mesh=mesh) as ss:
            qids = {ss.subscribe(StandingQuery(m, d, args.k,
                                               seed=args.seed)): (m, d)
                    for m in motifs for d in deltas}
            print(f"replaying {args.stream_replay}  horizon={args.horizon}  "
                  f"batch={args.replay_batch}  queries={len(qids)}")
            for er in replay_epochs(ss, args.stream_replay,
                                    batch_size=args.replay_batch,
                                    advance_every=args.advance_every):
                ep = er.epoch
                print(f"epoch {ep.index}: m={ep.m_real} n={ep.n_real} "
                      f"t=[{ep.t_lo},{ep.t_hi}] evicted={ep.evicted} "
                      f"buckets={ep.buckets} ({er.advance_s:.2f}s)")
                for qid in sorted(er.results):
                    res = er.results[qid]
                    rse = res.rse
                    print(f"  {qids[qid][0]:12s} delta={qids[qid][1]:<8d} "
                          f"C^={res.estimate:12.4g}  "
                          f"rse={'inf' if rse is None else f'{rse:.3f}'}  "
                          f"k={res.k}")
        return

    g = parse_graph(args.graph)

    if args.serve:
        from ..api import Session, serve_loop
        cfg = EstimateConfig(chunk=args.chunk, seed=args.seed,
                             coalesce_window_s=args.coalesce_window,
                             coalesce_max_requests=args.coalesce_max,
                             device=args.device)
        session = Session(g, cfg, mesh=mesh)
        # stdout is the response stream: logs go to stderr
        print(f"serving graph n={g.n} m={g.m} span={g.time_span}  "
              f"mesh={_mesh_shape(mesh)}  device={args.device}  "
              f"window={args.coalesce_window}s "
              f"max={args.coalesce_max}", file=sys.stderr, flush=True)
        served = serve_loop(session, profile_dir=args.profile_dir)
        print(f"served {served} requests", file=sys.stderr)
        return

    print(f"graph: n={g.n} m={g.m} span={g.time_span}  "
          f"motifs={motifs} deltas={deltas}  k={args.k}  "
          f"mesh={_mesh_shape(mesh)}  device={args.device}")
    exact_cache: dict = {}

    if len(motifs) > 1 or len(deltas) > 1:
        if args.checkpoint:
            raise SystemExit("--checkpoint is per-job and not supported in "
                             "batched mode yet; run jobs singly to resume")
        from ..core.batch import estimate_many
        jobs = [(m, d, args.k) for m in motifs for d in deltas]
        for res in estimate_many(g, jobs, seed=args.seed, chunk=args.chunk,
                                 device=args.device, mesh=mesh):
            print(f"delta={res.delta}  fused={res.fused_jobs}  "
                  f"{res.summary()}")
            if args.exact:
                _print_exact(g, res, exact_cache)
        return

    from ..core.estimator import estimate
    res = estimate(g, get_motif(motifs[0]), deltas[0], args.k,
                   seed=args.seed, chunk=args.chunk,
                   checkpoint_path=args.checkpoint, device=args.device,
                   mesh=mesh)
    print(res.summary())
    print(f"  fail: vmap={res.fail_vmap} delta={res.fail_delta} "
          f"order={res.fail_order} overflow={res.overflow}  "
          f"device={args.device}")
    if args.exact:
        _print_exact(g, res, exact_cache)


if __name__ == "__main__":
    main()

"""Closed loop of TIMEST batches through one resident ``api.Session``.

Set-up makes the configuration's edges (``make_edges``), indexes them
through the program's ``TemporalGraph.from_edges`` and
``device_arrays``, opens a ``Session`` with the mix's chunk and warms it
with whole batches of the mix (the plans, every candidate's weights,
the kernels' builds).  The one client then submits a batch, every motif
of the mix at ``delta`` with ``k`` samples and one seed drawn from
``--seed``, through ``Session.submit_many``, waits for every answer,
and submits the next, until ``--seconds`` have passed.

The check, once the window has closed: the program's graph index, and
every request of one batch drawn from the seed, of the window's last
batch (after the cached plans and weights have served all the others)
and, in a traced run, of the profiled batch, are held against the
reference (``bench.reference``), which re-derives them from the same
edges.
"""
from __future__ import annotations

import gc
import random
import time

import torch

#: the batch a traced run profiles (the second of the window)
PROFILED_BATCH = 1
#: whole batches of the mix run in set-up
WARMUP_BATCHES = 1
#: batch seeds drawn ahead: more batches than any window holds
MAX_BATCHES = 1 << 16


def batch_seeds(seed: int, n: int) -> list:
    """The seeds of the first ``n`` batches: warm-up batches first."""
    r = random.Random(int(seed))
    return [r.getrandbits(32) for _ in range(n)]


def make_edges(plugin, cfg: dict, seed: int, device):
    """The configuration's edges: its generator's draw at ``data_seed``,
    with the vertices relabelled by a permutation drawn from ``seed``.
    Every seed gets the same graph up to isomorphism (the same sizes,
    weights, plans and work) in other arrays."""
    src, dst, t = plugin("gen", cfg["generator"]).generate(
        cfg, int(cfg["data_seed"]), device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    perm = torch.randperm(int(cfg["vertices"]), generator=gen, device=device)
    return perm[src], perm[dst], t


def requests_of(mix: dict, seed: int) -> list:
    return [(name, int(mix["delta"]), int(mix["k"]), int(seed))
            for name in mix["motifs"]]


def setup(ctx) -> None:
    from repro_torch import obs
    from repro_torch.api import EstimateConfig, Session
    from repro_torch.core.graph import TemporalGraph

    cfg, mix = ctx.config, ctx.traffic
    t0 = time.perf_counter()
    ctx.edges = make_edges(ctx.plugin, cfg, ctx.seed, ctx.device)
    host = [x.cpu().numpy() for x in ctx.edges]
    ctx.log(generate_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    g = TemporalGraph.from_edges(*host)
    dev = g.device_arrays(ctx.device)
    ctx.sync()
    ctx.graph_build_s = time.perf_counter() - t0
    ctx.log(graph=dict(n=g.n, m=g.m, pairs=g.num_pairs,
                       time_span=g.time_span,
                       build_s=ctx.graph_build_s))
    if ctx.trace:
        obs.set_level("trace")
        obs.set_ring(1 << 20)
    ctx.session = Session(g, EstimateConfig(
        chunk=int(mix["chunk"]), device=str(ctx.device)), dev=dev)
    ctx.seeds = batch_seeds(ctx.seed, WARMUP_BATCHES + MAX_BATCHES)
    t0 = time.perf_counter()
    for i in range(WARMUP_BATCHES):
        _run_batch(ctx, -1 - i, ctx.seeds[i])
    ctx.log(warm_up_s=time.perf_counter() - t0)
    ctx.seeds = ctx.seeds[WARMUP_BATCHES:]
    for (name, delta, _, _), res in zip(requests_of(mix, 0),
                                        ctx.warm_results):
        ctx.log(plan=dict(motif=name, delta=delta, W=res.W,
                          tree=list(res.tree_edges),
                          fused_jobs=res.fused_jobs))


def _run_batch(ctx, index: int, seed: int) -> list:
    """Submit one batch and wait for all of its answers."""
    from repro_torch import obs
    from repro_torch.api import Request

    reqs = requests_of(ctx.traffic, seed)
    t_submit = time.perf_counter()
    with obs.span("bench.batch", batch=index):
        handles = ctx.session.submit_many(
            [Request(motif=n, delta=d, k=k, seed=s) for n, d, k, s in reqs])
        out = []
        for h, r in zip(handles, reqs):
            try:
                out.append((r, h.result(), None))
            except RuntimeError as e:
                out.append((r, None, repr(e)))
    t_done = time.perf_counter()
    if index < 0:
        bad = [e for *_, e in out if e]
        if bad:
            raise RuntimeError(f"warm-up batch failed: {bad[0]}")
        ctx.warm_results = [res for _, res, _ in out]
    return [dict(batch=index, request=r, result=res, error=err,
                 t_submit=t_submit, t_done=t_done) for r, res, err in out]


def window(ctx) -> None:
    """The measured window: batches back to back until ``seconds``."""
    ctx.records = []
    t0 = ctx.window_t0 = time.perf_counter()
    i = 0
    while (time.perf_counter() - t0 < ctx.seconds
           or (ctx.trace and i <= PROFILED_BATCH)):
        if ctx.trace and i == PROFILED_BATCH:
            batch = []
            ctx.slice = ctx.profile(
                lambda: batch.extend(_run_batch(ctx, i, ctx.seeds[i])))
            ctx.records += batch
        else:
            ctx.records += _run_batch(ctx, i, ctx.seeds[i])
        i += 1
    ctx.window_s = time.perf_counter() - t0
    walls = sorted(r["t_done"] - r["t_submit"]
                   for r in ctx.records[::len(ctx.traffic["motifs"])])
    ctx.log(window=dict(batches=i, seconds=ctx.window_s,
                        batch_s_min=walls[0],
                        batch_s_median=walls[len(walls) // 2],
                        batch_s_max=walls[-1]))


def check(ctx) -> None:
    """Free the program's state, then hold its outputs against the
    reference; fills ``ctx.checks`` (name -> (value, limit))."""
    from bench.reference.check import compare
    from bench.reference.estimate import Reference
    from bench.reference.graph import arrays_differing
    from bench.yardstick.bytes import sampler_bytes

    mix = ctx.traffic
    done = sorted({r["batch"] for r in ctx.records})
    pick = {random.Random(int(ctx.seed) ^ 0x5EED).choice(done), done[-1]}
    if ctx.trace:
        pick.add(PROFILED_BATCH)
    dev = ctx.session.dev
    ctx.session = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ref = Reference(*ctx.edges)
    graph_bad = arrays_differing(dev, ref.g)
    del dev
    bad = dict(plans=0, sums=0, estimates=0, unanswered=0)
    ctx.sampler_bytes, ctx.sampler_launches = 0, 0

    def count_bytes(tree, w, edges, window):
        ctx.sampler_bytes += sampler_bytes(ref.g, ref.k, tree, w, edges,
                                           window)
        ctx.sampler_launches += 1

    for b in sorted(pick):
        recs = [r for r in ctx.records if r["batch"] == b]
        profiled = ctx.trace and b == PROFILED_BATCH
        want = ref.run([r["request"] for r in recs], int(mix["chunk"]),
                       on_chunk=count_bytes if profiled else None)
        got = [None if r["result"] is None else answer(r["result"])
               for r in recs]
        for key, v in compare(got, want).items():
            bad[key] += v
    ctx.log(check=dict(batches=sorted(pick), graph_arrays_bad=graph_bad,
                       reference_s=time.perf_counter() - t0))
    ctx.checks = {
        "graph_arrays_differing": (len(graph_bad), 0),
        "plans_differing": (bad["plans"], 0),
        "sums_differing": (bad["sums"], 0),
        "estimates_differing": (bad["estimates"], 0),
        "requests_unanswered": (bad["unanswered"], 0),
        "requests_failed": (summary(ctx)["failed"], 0),
    }


def answer(res) -> dict:
    """An ``EstimateResult`` as the reference states its answers."""
    return dict(W=res.W, tree_edges=tuple(res.tree_edges), k=res.k,
                estimate=res.estimate, cnt2=res.cnt2_sum, valid=res.valid,
                fail_vmap=res.fail_vmap, fail_delta=res.fail_delta,
                fail_order=res.fail_order, overflow=res.overflow)


def summary(ctx) -> dict:
    """Requests submitted in the window, and those that raised."""
    recs = ctx.records
    return dict(attempted=len(recs),
                failed=sum(1 for r in recs if r["error"] is not None))


"""The port's retry ladder, backoff and failure taxonomy, held against
the JAX package's.

* ``backoff_delays`` and ``backoff_delay`` give the reference's floats;
* every case of the reference's ``test_classify_battery`` classifies the
  same in both packages, and the card's faults classify as documented:
  ``torch.cuda.OutOfMemoryError`` and a kernel launch error carrying
  ``cudaErrorMemoryAllocation`` are retryable, the same launch error
  with ``cudaErrorIllegalAddress`` is fatal;
* under the same ``FaultInjector`` schedule the port's engine ladder and
  the reference's at ``sampler_backend="xla"`` give equal results,
  ``fallback_reason``, counters and injector logs (the port's tag is its
  device type, the reference's its backend): a transient fault retried,
  a fatal one not, the window halved, the ladder exhausted, fused
  siblings isolated, a witness window retried, a checkpoint torn
  mid-write then resumed, a ``serve.write`` fault counted.
"""
from __future__ import annotations

import io
import json

import pytest
import torch

from repro.api import EstimateConfig as RConfig
from repro.api import Request as RRequest
from repro.api import Session as RSession
from repro.api import serve_loop as ref_serve_loop
from repro.core import engine as rengine
from repro.core.estimator import estimate as ref_estimate
from repro.core.motif import get_motif as rmotif
from repro.graphs import powerlaw_temporal_graph as rgraph
from repro import resilience as rres
from repro.resilience import retry as rretry
from repro_torch import estimate, get_motif, powerlaw_temporal_graph
from repro_torch import resilience as res
from repro_torch.api import EstimateConfig, Request, Session, serve_loop
from repro_torch.core import engine
from repro_torch.kernels import _build
from repro_torch.resilience import retry

GRAPH = dict(n=150, m=2000, time_span=40000, seed=11)
DELTA, CHUNK, CKPT = 3000, 256, 2
FIELDS = ("estimate", "W", "k", "valid", "cnt2_sum", "fail_vmap",
          "fail_delta", "fail_order", "overflow", "tree_edges", "motif",
          "fallback_reason", "degraded", "degrade_reason", "witnesses",
          "mesh_shape")
ENGINE_COUNTERS = ("dispatches", "fused_dispatches", "job_windows",
                   "tree_cohorts", "cohort_motif_lanes", "samples_shared",
                   "witness_dispatches")


@pytest.fixture(scope="module")
def graphs():
    return rgraph(**GRAPH), powerlaw_temporal_graph(**GRAPH)


# ---------------------------------------------------------------------------
# backoff and taxonomy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", [
    dict(), dict(max_attempts=6, base_s=0.01, cap_s=0.05),
    dict(max_attempts=4, base_s=0.2, cap_s=1.0, multiplier=3.0,
         jitter=0.25)])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3])
def test_backoff_delays_equal_the_reference(policy, seed):
    got = retry.backoff_delays(retry.RetryPolicy(**policy), seed=seed)
    want = rretry.backoff_delays(rretry.RetryPolicy(**policy), seed=seed)
    assert got == want and len(got) == retry.RetryPolicy(
        **policy).max_attempts - 1
    assert retry.DISPATCH_POLICY == retry.RetryPolicy()
    assert retry.backoff_delay(retry.DISPATCH_POLICY, 1, seed=seed) \
        == rretry.backoff_delay(rretry.DISPATCH_POLICY, 1, seed=seed)


def _battery(pkg):
    """The reference's ``test_classify_battery`` cases, built from one
    package's marker classes."""
    return [pkg.TransientError("x"), TimeoutError("x"), ConnectionError("x"),
            MemoryError("x"), pkg.FatalError("x"), RuntimeError("x"),
            AssertionError("x"), ValueError("x"), TypeError("x"),
            KeyError("x"), pkg.BadRequestError("x"),
            pkg.OverloadedError("x")]


def test_classify_battery_equals_the_reference():
    got = [res.classify(e) for e in _battery(res)]
    want = [rres.classify(e) for e in _battery(rres)]
    assert got == want
    assert got == ["retryable"] * 4 + ["fatal"] * 3 + ["bad_request"] * 4 \
        + ["overloaded"]

    class XlaRuntimeError(Exception):
        pass

    for msg in ("RESOURCE_EXHAUSTED: Out of memory", "UNAVAILABLE: lost",
                "INVALID_ARGUMENT: shape mismatch"):
        assert res.classify(XlaRuntimeError(msg)) \
            == rres.classify(XlaRuntimeError(msg))
    assert res.error_payload(ValueError("no such motif")) \
        == rres.error_payload(ValueError("no such motif"))


def test_card_faults_classify_for_the_ladder():
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory")
    assert res.classify(oom) == "retryable" and res.is_retryable(oom)
    with pytest.raises(res.CudaLaunchError) as alloc:
        _build.check(2, "tree_sampler")        # cudaErrorMemoryAllocation
    assert isinstance(alloc.value, RuntimeError)
    assert alloc.value.code == 2 and alloc.value.kernel == "tree_sampler"
    assert res.classify(alloc.value) == "retryable"
    with pytest.raises(res.CudaLaunchError) as illegal:
        _build.check(700, "tree_sampler")      # cudaErrorIllegalAddress
    assert illegal.value.code == 700
    assert res.classify(illegal.value) == "fatal"
    for sticky in (710, 719, 1):               # assert, launch failure
        assert res.classify(res.CudaLaunchError("k", sticky)) == "fatal"
    _build.check(0, "tree_sampler")            # success raises nothing


# ---------------------------------------------------------------------------
# the ladder under one schedule in both packages
# ---------------------------------------------------------------------------
def _reset():
    engine.STATS.reset()
    res.STATS.reset()
    rengine.STATS.reset()
    rretry.STATS.reset()


def _under(pkg, specs, fn):
    """Run ``fn`` under ``pkg``'s injector: (result or exception, log)."""
    with pkg.FaultInjector(specs) as inj:
        try:
            out = fn()
        except Exception as e:          # noqa: BLE001 — compared below
            out = e
    return out, inj.log


def _both(specs_of, ref_fn, port_fn, tags=(("cpu", "xla"),)):
    """The same schedule (``specs_of(pkg, tag)``) in both packages: equal
    injector logs (the port's tags mapped to the reference's by
    ``tags``) and equal counters.  Returns (port's, reference's)."""
    _reset()
    want, wlog = _under(rres, specs_of(rres, "xla"), ref_fn)
    got, glog = _under(res, specs_of(res, "cpu"), port_fn)
    mapped = []
    for site, tag, hit, fired in glog:
        for a, b in tags:
            tag = tag.replace(a, b)
        mapped.append((site, tag, hit, fired))
    assert mapped == wlog
    assert res.STATS.as_dict() == rretry.STATS.as_dict()
    assert {f: getattr(engine.STATS, f) for f in ENGINE_COUNTERS} \
        == {f: getattr(rengine.STATS, f) for f in ENGINE_COUNTERS}
    return got, want


def _same(got, want):
    if isinstance(want, Exception):
        assert type(got).__name__ == type(want).__name__
        assert str(got).replace("cpu", "xla") == str(want)
        return
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f


def _est(graphs, k=1024, seed=0, **kw):
    rg, g = graphs
    return (lambda: ref_estimate(rg, rmotif("M5-3"), DELTA, k, seed=seed,
                                 chunk=CHUNK, checkpoint_every=CKPT,
                                 sampler_backend="xla", **kw),
            lambda: estimate(g, get_motif("M5-3"), DELTA, k, seed=seed,
                             chunk=CHUNK, checkpoint_every=CKPT,
                             device="cpu", **kw))


LADDER = {
    "transient_retried": (lambda p, tag: [p.FaultSpec(
        "engine.dispatch", hits=(0,), tag=tag)]),
    "fatal_not_retried": (lambda p, tag: [p.FaultSpec(
        "engine.dispatch", hits=(0,), exc=p.FatalError)]),
    "window_halved": (lambda p, tag: [p.FaultSpec(
        "engine.dispatch", hits=(0, 1, 2), tag=tag)]),
    "ladder_exhausted": (lambda p, tag: [p.FaultSpec(
        "engine.dispatch", hits=None, tag=tag)]),
    "sampler_call_halved": (lambda p, tag: [p.FaultSpec(
        "sampler.call", hits=(0,), tag=tag)]),
}


@pytest.mark.parametrize("case", sorted(LADDER))
def test_ladder_equals_the_reference(graphs, case):
    ref_fn, port_fn = _est(graphs)
    got, want = _both(LADDER[case], ref_fn, port_fn)
    _same(got, want)
    if case == "transient_retried":
        assert res.STATS.retries == 1 and got.fallback_reason == ""
    elif case == "fatal_not_retried":
        assert isinstance(got, res.FatalError) and res.STATS.retries == 0
    elif case == "window_halved":
        assert "dispatch window halved to 1" in got.fallback_reason
        assert res.STATS.ladder_steps == 1 and engine.STATS.dispatches == 4
    elif case == "ladder_exhausted":
        assert isinstance(got, res.TransientError)
    else:
        assert "halved to 1" in got.fallback_reason
        assert res.STATS.retries == 0 and res.STATS.ladder_steps == 1


def test_ladder_isolates_fused_siblings(graphs):
    """Only the failing cohort degrades: the window-mate in another plan
    group keeps whole windows and its numbers."""
    rg, g = graphs

    def run(sess, req):
        h1 = sess.submit(req("M5-3", DELTA, 1024, seed=0))
        h2 = sess.submit(req("M4-2", DELTA, 512, seed=3))
        return h1.result(), h2.result()

    got, want = _both(
        lambda p, tag: [p.FaultSpec("engine.dispatch", hits=(0, 1, 2))],
        lambda: run(RSession(rg, RConfig(chunk=CHUNK, checkpoint_every=CKPT,
                                         coalesce_window_s=60.0,
                                         sampler_backend="xla")), RRequest),
        lambda: run(Session(g, EstimateConfig(
            chunk=CHUNK, checkpoint_every=CKPT, coalesce_window_s=60.0,
            device="cpu")), Request))
    for a, b in zip(got, want):
        _same(a, b)
    assert "halved" in got[0].fallback_reason
    assert got[1].fallback_reason == ""
    solo = estimate(g, get_motif("M4-2"), DELTA, 512, seed=3, chunk=CHUNK,
                    checkpoint_every=CKPT, device="cpu")
    assert got[1].cnt2_sum == solo.cnt2_sum and got[1].valid == solo.valid


def test_witness_window_retried(graphs):
    rg, g = graphs
    got, want = _both(
        lambda p, tag: [p.FaultSpec("engine.witness", hits=(0, 1), tag=tag)],
        lambda: RSession(rg, RConfig(chunk=CHUNK, checkpoint_every=CKPT,
                                     sampler_backend="xla")).submit(
            RRequest("M4-2", DELTA, 1024, witnesses=3)).result(),
        lambda: Session(g, EstimateConfig(
            chunk=CHUNK, checkpoint_every=CKPT, device="cpu")).submit(
            Request("M4-2", DELTA, 1024, witnesses=3)).result())
    _same(got, want)
    assert res.STATS.retries == 2 and len(got.witnesses) == 3
    clean = Session(g, EstimateConfig(chunk=CHUNK, checkpoint_every=CKPT,
                                      device="cpu")).submit(
        Request("M4-2", DELTA, 1024, witnesses=3)).result()
    assert got.witnesses == clean.witnesses


def test_checkpoint_torn_mid_write_then_resumed(graphs, tmp_path):
    """Both packages die mid-write of their second checkpoint (the first
    survives whole), then resume to the unbroken result; the files they
    leave are byte-equal."""
    paths = {p: str(tmp_path / f"{p}.ckpt") for p in ("ref", "port")}
    ref_fn, _ = _est(graphs, checkpoint_path=paths["ref"])
    _, port_fn = _est(graphs, checkpoint_path=paths["port"])
    got, want = _both(
        lambda p, tag: [p.FaultSpec("checkpoint.write", hits=(1,),
                                    exc=p.FatalError, tag=".ckpt")],
        ref_fn, port_fn, tags=(("port.ckpt", "ref.ckpt"),))
    assert type(got).__name__ == type(want).__name__ == "FatalError"
    assert open(paths["ref"]).read() == open(paths["port"]).read()
    assert json.load(open(paths["port"]))["chunks_done"] == CKPT
    resumed, resumed_ref = port_fn(), ref_fn()
    _same(resumed, resumed_ref)
    base = _est(graphs)[1]()
    assert resumed.cnt2_sum == base.cnt2_sum and resumed.valid == base.valid


def test_serve_write_fault_counted(graphs):
    rg, g = graphs
    lines = [{"id": 1, "motif": "M5-3", "delta": DELTA, "k": 512},
             {"cmd": "stats"}, {"cmd": "health"}, {"cmd": "quit"}]
    text = "".join(json.dumps(ln) + "\n" for ln in lines)

    def serve(loop, session):
        out = io.StringIO()
        served = loop(session, io.StringIO(text), out)
        return served, [json.loads(ln) for ln in out.getvalue().splitlines()]

    got, want = _both(
        lambda p, tag: [p.FaultSpec("serve.write", hits=(0,))],
        lambda: serve(ref_serve_loop, RSession(rg, RConfig(
            chunk=CHUNK, coalesce_window_s=60.0))),
        lambda: serve(serve_loop, Session(g, EstimateConfig(
            chunk=CHUNK, coalesce_window_s=60.0, device="cpu"))))
    assert got[0] == want[0] == 1
    assert res.STATS.emit_failures == 1
    # the lost first line is the response; stats, health and quit follow
    assert [ln.get("cmd") for ln in got[1]] == ["stats", "health", "quit"]
    assert got[1][1]["resilience"] == want[1][1]["resilience"]
    assert got[1][1]["resilience"]["emit_failures"] == 1

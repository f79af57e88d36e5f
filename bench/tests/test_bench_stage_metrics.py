"""The readers of the program's stage records (``sampler.draw``,
``validate.lane``, ``planner.weights``, ``kernels.build``): each, on a
hand-built run (a synthetic profiled slice and records in the program's
flight recorder), returns the hand-computed value, and ``None`` where
the records are absent; ``weights_dp_s`` also reads a real traced
planner on the CPU."""
from types import SimpleNamespace

import pytest
import torch

from bench import run as harness
from bench.tests import small
from bench.yardstick.trace import Slice
from repro_torch import obs
from repro_torch.api import EstimateConfig, Request, Session
from repro_torch.core.graph import TemporalGraph

READERS = ("sampler_device_ms_per_chunk.samples",
           "validate_device_ms_per_lane_chunk.samples",
           "validate_idle.samples", "weights_dp_s")


@pytest.fixture(autouse=True)
def _empty_recorder():
    obs.RECORDER.clear()
    yield
    obs.set_level(None)
    obs.RECORDER.clear()


def read(name, ctx):
    return harness.plugin("metrics", name).read(ctx)


def put(name, span, t0, dur_s=0.0, parent=0, **extra):
    rec = {"name": name, "trace": None, "span": span, "parent": parent,
           "t0": t0, "dur_s": dur_s, "thread": "MainThread"}
    attrs = extra.pop("attrs", None)
    rec.update(extra)
    if attrs is not None:
        rec["attrs"] = attrs
    obs.RECORDER.append(rec)


def ctx_of(slice_=None, window_t0=10.0):
    return SimpleNamespace(slice=slice_, window_t0=window_t0)


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_records(name):
    s = Slice(wall_s=1.0, host_t0=20.0, device=[(0, 1, "k")], runtime=[])
    assert read(name, ctx_of(s)) is None
    assert read(name, ctx_of(None)) is None


@pytest.mark.parametrize("name,stage", [
    ("sampler_device_ms_per_chunk.samples", "sampler.draw"),
    ("validate_device_ms_per_lane_chunk.samples", "validate.lane")])
def test_device_ms_means_over_the_window_outside_the_slice(name, stage):
    s = Slice(wall_s=1.0, host_t0=20.0, device=[], runtime=[])
    put(stage, 1, 12.0, device_ms=10.0)
    put(stage, 2, 5.0, device_ms=99.0)           # set-up: not counted
    put(stage, 3, 20.5, device_ms=50.0)          # the profiled slice
    put(stage, 4, 30.0, device_ms=14.0)
    put(stage, 5, 31.0)                          # no device time (CPU)
    put("engine.device", 6, 32.0, device_ms=1000.0)
    assert read(name, ctx_of(s)) == 12.0
    assert read(name, ctx_of(None)) == pytest.approx(74.0 / 3)
    obs.RECORDER.clear()
    put(stage, 1, 12.0)                          # a CPU run's records
    assert read(name, ctx_of(s)) is None


def test_validate_idle_on_the_profilers_clock():
    obs.set_anchor()
    s = Slice(wall_s=1e-3, host_t0=100.0, device=[], runtime=[])
    start = obs.profiler_ns(100.0)
    s.device = [(start, start + 150_000, "a"),
                (start + 350_000, start + 950_000, "b")]
    lane = [(100_000, 300_000), (250_000, 400_000),   # union 100k-400k
            (900_000, 1_100_000),                     # clipped at 1000k
            (-500_000, -100_000)]                     # before the slice
    for i, (a, b) in enumerate(lane):
        put("validate.lane", i + 1, 100.0 + a / 1e9, (b - a) / 1e9,
            ts_ns=start + a)
    put("sampler.draw", 9, 100.0, 1e-3, ts_ns=start)  # not a lane
    # host in lanes 400k ns, of which busy 50k + 50k + 50k: idle 250k
    assert read("validate_idle.samples", ctx_of(s)) == pytest.approx(25.0)
    obs.RECORDER.clear()
    put("validate.lane", 1, 100.0, 1e-4)              # no ts_ns
    assert read("validate_idle.samples", ctx_of(s)) is None


def test_weights_dp_s_is_miss_time_less_builds():
    put("kernels.build", 2, 1.1, 0.2, parent=1)
    put("planner.weights", 1, 1.0, 0.5, attrs={"hit": False})
    put("planner.weights", 3, 2.0, 0.001, attrs={"hit": True})
    put("kernels.build", 6, 3.1, 0.05, parent=5)      # a grandchild
    put("inner", 5, 3.05, 0.1, parent=4)
    put("planner.weights", 4, 3.0, 0.3, attrs={"hit": False})
    put("kernels.build", 7, 4.0, 9.0)                 # outside a miss
    assert read("weights_dp_s", ctx_of()) == pytest.approx(0.55)


def test_weights_dp_s_reads_a_traced_planner_on_the_cpu():
    loop = harness.plugin("loops", "session_batches")
    cfg = small.config("wikitalk", 2000)
    src, dst, t = loop.make_edges(harness.plugin, cfg, 5,
                                  torch.device("cpu"))
    g = TemporalGraph.from_edges(src.numpy(), dst.numpy(), t.numpy())
    obs.set_level("trace")
    s = Session(g, EstimateConfig(chunk=256, device="cpu"))
    for h in s.submit_many([Request(m, 3600, 256, seed=1)
                            for m in ("M4-1", "M4-3")]):
        h.result()
    got = read("weights_dp_s", ctx_of())
    assert got > 0 and got == pytest.approx(s.planner.preprocess_s,
                                            abs=1e-6)

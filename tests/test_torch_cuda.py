"""The port's CUDA kernels on the card against their plain versions.

Marked ``cuda``: each test skips (inside the ``cuda_device`` fixture)
where there is no GPU.  On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Only the port is imported here, so the file also runs where jax is not
installed.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch import estimate, get_motif, powerlaw_temporal_graph
from repro_torch.core import rng
from repro_torch.core.spanning_tree import candidate_trees
from repro_torch.core.weights import preprocess
from repro_torch.kernels.interval_weight.ops import dep_sum
from repro_torch.kernels.interval_weight.ref import dep_sum_ref
from repro_torch.kernels.tree_sampler.ops import (build_schedule,
                                                  prepare_draws,
                                                  tree_sampler_keyed)
from repro_torch.kernels.tree_sampler.ref import tree_sampler_ref

pytestmark = pytest.mark.cuda

GRAPH = dict(n=400, m=6000, time_span=60000, seed=3)
FIELDS = ("estimate", "W", "k", "cnt2_sum", "valid", "fail_vmap",
          "fail_delta", "fail_order", "overflow", "tree_edges")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("motif", ["M5-3", "M4-2"])
@pytest.mark.parametrize("use_c2", [True, False])
@pytest.mark.parametrize("use_c3", [True, False])
def test_kernels_equal_plain_versions(cuda_device, motif, use_c2, use_c3):
    """Both TIMEST kernels bit-equal to their plain versions: the dep-sum
    for every dependency and window of the DP, the keyed sampler at K = 1
    and at K not a multiple of the block; C3 off leaves one window
    (q = 1).  Each launch counts once."""
    g = powerlaw_temporal_graph(**GRAPH)
    tree = candidate_trees(get_motif(motif))[0]
    dev = g.device_arrays(cuda_device)
    wts = preprocess(g, tree, 2000, dev=dev, use_c2=use_c2, use_c3=use_c3)
    assert (wts.q == 1) == (not use_c3)
    for s in tree.topo_down:
        for d in tree.deps[s]:
            c = d.child
            ps_csr = (wts.ps_acc_own[c], wts.ps_acc_prev[c])
            ps_pair = ((wts.ps_pair_own[c], wts.ps_pair_prev[c]) if use_c2
                       else None)
            for window in ("own", "prev"):
                args = (dev, d, window, wts.delta, wts.wd, ps_csr, ps_pair)
                n = dep_sum.launches
                got = dep_sum(*args)
                assert dep_sum.launches == n + 1
                assert torch.equal(got, dep_sum_ref(*args))
    schedule = build_schedule(tree)
    args = (schedule, tree.root, tree.num_edges, dev, wts)
    key = rng.fold_in(rng.PRNGKey(1), 3).to(cuda_device)
    for K in (1, 777, 4096 + 5):
        want = tree_sampler_ref(*args, *prepare_draws(tree, wts, key, K))
        n = tree_sampler_keyed.launches
        got = tree_sampler_keyed(*args, key, K)
        torch.cuda.synchronize()
        assert tree_sampler_keyed.launches == n + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    other = tree_sampler_keyed(*args, rng.PRNGKey(2).to(cuda_device), 777)
    assert not torch.equal(other[0], want[0][:777])
    # a window total past 2^32: jax's randint reduction wraps (mult = 0)
    wide = dataclasses.replace(
        wts, W_total=torch.tensor(2 ** 40 + 7, device=cuda_device))
    args = (schedule, tree.root, tree.num_edges, dev, wide)
    got = tree_sampler_keyed(*args, key, 777)
    want = tree_sampler_ref(*args, *prepare_draws(tree, wide, key, 777))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("motif,k,seed", [("M5-3", 1024, 0),
                                          ("M4-2", 512, 3)])
def test_card_estimate_equals_cpu(cuda_device, motif, k, seed):
    g = powerlaw_temporal_graph(**GRAPH)
    kw = dict(seed=seed, chunk=256)
    card = estimate(g, get_motif(motif), 2000, k, device=cuda_device, **kw)
    cpu = estimate(g, get_motif(motif), 2000, k, device="cpu", **kw)
    for f in FIELDS:
        assert getattr(card, f) == getattr(cpu, f), f


@pytest.mark.parametrize("J,K", [(1, 777), (3, 4096 + 5), (5, 1)])
def test_multi_stream_sampler_equals_solo_launches_and_cpu(cuda_device, J,
                                                           K):
    """One launch for a ``[J, 2]`` key stack: stream ``i`` is
    ``torch.equal`` to a solo launch on ``keys[i]`` and to the CPU path
    (``prepare_draws`` + the plain version) on the same key."""
    g = powerlaw_temporal_graph(**GRAPH)
    tree = candidate_trees(get_motif("M5-3"))[0]
    dev = g.device_arrays(cuda_device)
    wts = preprocess(g, tree, 2000, dev=dev)
    cdev = g.device_arrays("cpu")
    cwts = preprocess(g, tree, 2000, dev=cdev)
    schedule = build_schedule(tree)
    keys = rng.fold_in(rng.PRNGKey(7), torch.arange(J) * 11 + 2)
    args = (schedule, tree.root, tree.num_edges)
    n = tree_sampler_keyed.launches
    edges, window = tree_sampler_keyed(*args, dev, wts,
                                       keys.to(cuda_device), K)
    torch.cuda.synchronize()
    assert tree_sampler_keyed.launches == n + 1
    assert edges.shape == (J, K, tree.num_edges) and window.shape == (J, K)
    cpu = tree_sampler_keyed(*args, cdev, cwts, keys, K)
    assert torch.equal(edges.cpu(), cpu[0])
    assert torch.equal(window.cpu(), cpu[1])
    for i in range(J):
        solo = tree_sampler_keyed(*args, dev, wts, keys[i].to(cuda_device),
                                  K)
        assert torch.equal(edges[i], solo[0])
        assert torch.equal(window[i], solo[1])


def test_card_cohort_equals_cpu(cuda_device):
    """A tree cohort through ``estimate_many`` on the card equals the CPU
    run field for field, with one sampler launch per chunk for all its
    seed streams."""
    from repro_torch import estimate_many
    from repro_torch.core.engine import STATS
    g = powerlaw_temporal_graph(**GRAPH)
    jobs = [(m, 2000, 1024, s) for m in ("M5-2", "M5-3", "M5-4")
            for s in (0, 1)]
    n = tree_sampler_keyed.launches
    STATS.reset()
    card = estimate_many(g, jobs, chunk=256, device=cuda_device)
    launches, windows = tree_sampler_keyed.launches - n, STATS.dispatches
    cpu = estimate_many(g, jobs, chunk=256, device="cpu")
    for a, b in zip(card, cpu):
        for f in FIELDS + ("fused_jobs",):
            assert getattr(a, f) == getattr(b, f), f
    assert launches == windows * 1024 // 256


def test_card_mesh_equals_meshless(cuda_device):
    """A 3-shard mesh on the card (shards round-robin on the visible
    cards) equals the meshless estimate field for field; the sampler is
    launched once per chunk summed over the shards, the dep-sum as
    often as without a mesh."""
    from repro_torch.kernels.interval_weight.ops import dep_sum
    from repro_torch.launch.mesh import make_estimator_mesh
    g = powerlaw_temporal_graph(**GRAPH)
    kw = dict(seed=0, chunk=256, checkpoint_every=3)
    counts = []
    for mesh in (None, make_estimator_mesh(3)):
        n, d = tree_sampler_keyed.launches, dep_sum.launches
        res = estimate(g, get_motif("M5-3"), 2000, 2048, mesh=mesh, **kw)
        counts.append((tree_sampler_keyed.launches - n, dep_sum.launches - d))
        if mesh is None:
            plain = res
    for f in FIELDS:
        assert getattr(res, f) == getattr(plain, f), f
    assert res.mesh_shape == (3,) and plain.mesh_shape is None
    assert counts[0] == counts[1] and counts[0][0] == 2048 // 256


def test_mesh_across_cards_equals_meshless(cuda_device):
    """Shards on separate cards: each card gets its own copy of the
    graph and Weights and runs its shards; the result is the meshless
    one.  Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    from repro_torch.launch.mesh import make_estimator_mesh
    g = powerlaw_temporal_graph(**GRAPH)
    kw = dict(seed=1, chunk=256, checkpoint_every=3)
    mesh = make_estimator_mesh(2 * torch.cuda.device_count())
    assert len(set(mesh.devices)) == torch.cuda.device_count()
    plain = estimate(g, get_motif("M4-2"), 2000, 4096, **kw)
    got = estimate(g, get_motif("M4-2"), 2000, 4096, mesh=mesh, **kw)
    for f in FIELDS:
        assert getattr(got, f) == getattr(plain, f), f


# -- padded epoch snapshots and witnesses ---------------------------------
@pytest.mark.parametrize("motif", ["M5-3", "M4-2"])
@pytest.mark.parametrize("m_floor", [8192, 1 << 16])
def test_kernels_on_a_padded_snapshot(cuda_device, motif, m_floor):
    """On a padded snapshot (two pad vertices with long equal-time
    segments, a flat prefix suffix, bucketed windows; at the larger floor
    nine edges in ten are pads)
    every dep-sum equals its plain version, and the keyed sampler equals
    its plain version and never returns an edge id >= m_real."""
    from repro_torch.core.graph import pad_snapshot
    g = pad_snapshot(powerlaw_temporal_graph(**GRAPH), m_floor=m_floor)
    tree = candidate_trees(get_motif(motif))[0]
    dev = g.device_arrays(cuda_device)
    wts = preprocess(g, tree, 2000, dev=dev)
    assert wts.q_pad > wts.q and g.m > g.live_m
    for s in tree.topo_down:
        for d in tree.deps[s]:
            c = d.child
            args = (dev, d, None, wts.delta, wts.wd,
                    (wts.ps_acc_own[c], wts.ps_acc_prev[c]),
                    (wts.ps_pair_own[c], wts.ps_pair_prev[c]))
            for window in ("own", "prev"):
                a = args[:2] + (window,) + args[3:]
                assert torch.equal(dep_sum(*a), dep_sum_ref(*a))
    schedule = build_schedule(tree)
    args = (schedule, tree.root, tree.num_edges, dev, wts)
    for seed in range(3):
        key = rng.fold_in(rng.PRNGKey(seed), 1).to(cuda_device)
        want = tree_sampler_ref(*args, *prepare_draws(tree, wts, key, 4096))
        got = tree_sampler_keyed(*args, key, 4096)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert int(got[0].max()) < g.live_m
        assert int(got[1].max()) < wts.q


def test_card_witnesses_equal_cpu(cuda_device):
    """The witness window on the card (a second sampler launch per chunk)
    equals the CPU's, and a stream of padded epochs gives the CPU's
    epochs and witnesses."""
    import numpy as np

    from repro_torch.api import EstimateConfig
    from repro_torch.core.engine import STATS
    from repro_torch.stream import StandingQuery, StreamingSession
    g = powerlaw_temporal_graph(**GRAPH)
    runs = []
    for device in (cuda_device, "cpu"):
        ss = StreamingSession(config=EstimateConfig(chunk=256,
                                                    device=str(device)),
                              horizon=30000)
        ss.subscribe(StandingQuery("M5-3", 2000, 1024))
        ss.subscribe(StandingQuery("M4-2", 2000, 1024, seed=3,
                                   witnesses=8))
        STATS.reset()
        n = tree_sampler_keyed.launches
        out = []
        for idx in np.array_split(np.arange(g.m), 3):
            ss.ingest(g.src[idx], g.dst[idx], g.t[idx])
            er = ss.advance()
            out.append([(er.epoch.m_real, er.epoch.buckets)]
                       + [tuple(getattr(r, f) for f in FIELDS
                                + ("witnesses",))
                          for r in er.results.values()])
        ss.close()
        runs.append((out, tree_sampler_keyed.launches - n,
                     STATS.witness_chunks))
    (card, launches, redraws), (cpu, _, _) = runs
    assert card == cpu and any(row[2][-1] for row in card)
    assert redraws == 3 * 4 and launches == 3 * 8 + redraws


# -- the LM serving path -------------------------------------------------
FA_CUDA_CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, causal, window, softcap): the six cases of
    # tests/test_kernels.py, ragged lengths, and every head dim
    (1, 128, 128, 4, 2, 32, True, 0, 0.0),
    (2, 256, 256, 4, 4, 64, True, 0, 0.0),
    (1, 256, 256, 8, 2, 32, True, 64, 0.0),
    (1, 128, 128, 4, 2, 32, True, 0, 50.0),
    (1, 128, 256, 4, 2, 32, False, 0, 0.0),
    (2, 384, 384, 6, 3, 64, True, 128, 30.0),
    (1, 200, 200, 4, 2, 16, True, 48, 50.0),
    (2, 70, 130, 2, 1, 128, False, 0, 0.0),
    (1, 333, 333, 4, 2, 256, True, 100, 50.0),
]


@pytest.mark.parametrize("case", FA_CUDA_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_attention_kernel_equals_plain_version(cuda_device, case,
                                                     dtype, tol):
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    B, Sq, Skv, Hq, Hkv, D, causal, window, cap = case
    g = torch.Generator(device=cuda_device).manual_seed(Sq + D)
    q, k, v = (torch.randn(s, generator=g, device=cuda_device).to(dtype)
               for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    kw = dict(causal=causal, window=window, attn_softcap=cap)
    n = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    torch.testing.assert_close(got, flash_attention_ref(q, k, v, **kw),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ["gemma2-27b", "granite-8b",
                                  "deepseek-7b"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
def test_card_lm_equals_cpu(cuda_device, arch, dtype, tol):
    """Prefill (through the flash kernel) and 3 decode steps, card
    against CPU on the same numpy weights; f32 without TF32."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.convert import lm_from_numpy, numpy_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    params = numpy_params(cfg, seed=3)
    tokens = torch.as_tensor(
        np.random.default_rng(3).integers(0, cfg.vocab, (2, 23)))
    runs = []
    for device in ("cpu", cuda_device):
        model = lm_from_numpy(cfg, params, device=device)
        tok = tokens.to(device)
        n = flash_attention.launches
        logits, cache = model.prefill(tok[:, :20], 24, compute_dtype=dtype)
        out = [logits]
        for s in range(20, 23):
            logits, cache = model.decode_step(cache, tok[:, s:s + 1],
                                              compute_dtype=dtype)
            out.append(logits)
        launches = flash_attention.launches - n
        assert launches == (cfg.n_layers if device != "cpu" else 0)
        runs.append([x.cpu() for x in out] + [cache["k"].cpu()])
    for card, cpu in zip(runs[1], runs[0]):
        torch.testing.assert_close(card, cpu, atol=tol, rtol=tol)


SM90_CUDA_CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, causal, window, softcap, q scale): bf16 at
    # head dims 64 and 128, the sm90 kernel's inputs
    (1, 200, 200, 4, 4, 64, True, 0, 0.0, 1),        # ragged, MHA
    (2, 333, 333, 4, 2, 128, True, 100, 50.0, 1),    # GQA 2:1, window 100
    (1, 8200, 8200, 4, 1, 128, True, 4096, 50.0, 1),  # GQA 4:1, window 4096
    (1, 8200, 8200, 2, 2, 64, True, 0, 0.0, 1),      # long causal, ragged
    (1, 200, 333, 2, 2, 64, False, 0, 0.0, 1),       # Sq < Skv, no causal
    (2, 333, 200, 4, 2, 128, False, 0, 0.0, 1),      # Sq > Skv, no causal
    (1, 333, 200, 2, 1, 128, True, 0, 0.0, 1),       # Sq > Skv, causal
    (1, 384, 384, 8, 2, 64, False, 100, 30.0, 1),    # window, no causal
    (1, 256, 256, 4, 2, 128, True, 0, 50.0, 8),      # scores at the cap
    (2, 1, 1, 4, 2, 64, True, 0, 0.0, 1),            # Sq = Skv = 1
    (1, 1, 333, 4, 4, 128, False, 0, 0.0, 1),        # Sq = 1
]


def _kernel_tol(dtype: str) -> dict:
    """``chip_smoke.KERNEL_TOL[dtype]``: the limits the smoke run holds
    every kernel to against its plain version."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.KERNEL_TOL[dtype]


@pytest.mark.parametrize("case", SM90_CUDA_CASES)
def test_sm90_flash_kernel_equals_rounded_plain_version(cuda_device, case):
    """The wgmma kernel against the plain version on its own trajectory
    (``round_p=True``: p rounded to bf16 before P.V) under the smoke
    run's bf16 limits, plus per element what two p's rounded the other
    way at an f32 near-tie can move it (``p_rounding_allowance``: with a
    window of 100 keys or scores at the cap one p is a large share of a
    row); and against the default plain version (p in f32) under the
    2e-2 of the test above."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.testing import p_rounding_allowance
    B, Sq, Skv, Hq, Hkv, D, causal, window, cap, scale = case
    g = torch.Generator(device=cuda_device).manual_seed(Sq + Skv + D)
    q, k, v = (torch.randn(s, generator=g, device=cuda_device)
               .to(torch.bfloat16)
               for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    q = q * scale                                     # exact in bf16
    kw = dict(causal=causal, window=window, attn_softcap=cap)
    n, n90 = flash_attention.launches, flash_attention.launches_sm90
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    assert flash_attention.launches_sm90 == n90 + 1
    want = flash_attention_ref(q, k, v, round_p=True, **kw).float()
    tol = _kernel_tol("bfloat16")
    err = (got.float() - want).abs()
    rms = float(want.pow(2).mean().sqrt())
    assert bool(torch.isfinite(got).all())
    allow = p_rounding_allowance(q, k, v, **kw)
    assert bool((err <= tol["atol_rel"] * rms + tol["rtol"] * want.abs()
                 + allow).all()), float(err.max())
    assert float((got.float() - want).norm() / want.norm()) \
        <= tol["rel_l2_max"]
    torch.testing.assert_close(got, flash_attention_ref(q, k, v, **kw),
                               atol=2e-2, rtol=2e-2)


def test_sm90_flash_kernel_reads_unaligned_views(cuda_device):
    """Views TMA cannot read as they are (a base off 16 bytes, a head
    stride that is no multiple of 16 bytes) are copied first."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         tma_ready)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    g = torch.Generator(device=cuda_device).manual_seed(5)
    base = torch.randn((1, 130, 4, 72), generator=g, device=cuda_device)
    q = base.to(torch.bfloat16)[..., 4:68]               # 8-byte offset
    kv = torch.randn((2 * 130 * 2 * 64 + 1,), generator=g,
                     device=cuda_device).to(torch.bfloat16)
    k = kv[1:1 + 130 * 2 * 64].view(1, 130, 2, 64)     # 2-byte offset
    v = kv[:130 * 2 * 64].view(1, 130, 2, 64)
    assert not tma_ready(q) and not tma_ready(k) and tma_ready(v)
    n90 = flash_attention.launches_sm90
    got = flash_attention(q, k, v, causal=True, window=0, attn_softcap=0.0)
    torch.cuda.synchronize()
    assert flash_attention.launches_sm90 == n90 + 1
    want = flash_attention_ref(q, k, v, round_p=True).float()
    assert float((got.float() - want).norm() / want.norm()) <= \
        _kernel_tol("bfloat16")["rel_l2_max"]


def test_card_lm_sm90_equals_cpu(cuda_device):
    """The Gemma-2 smoke config widened to head dim 128, bf16: prefill
    goes through the sm90 kernel in every layer (n_layers launches, none
    of the CUDA-core kernel) and agrees with the CPU run (which keeps p
    in f32) within the bf16 LM tolerance."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.convert import lm_from_numpy, numpy_params
    cfg = dataclasses.replace(get_smoke_config("gemma2-27b"), head_dim=128,
                              query_scale=128.0 ** -0.5)
    params = numpy_params(cfg, seed=4)
    tokens = torch.as_tensor(
        np.random.default_rng(4).integers(0, cfg.vocab, (2, 23)))
    runs = []
    for device in ("cpu", cuda_device):
        model = lm_from_numpy(cfg, params, device=device)
        tok = tokens.to(device)
        n90, nsimt = (flash_attention.launches_sm90,
                      flash_attention.launches_simt)
        logits, cache = model.prefill(tok[:, :20], 24,
                                      compute_dtype=torch.bfloat16)
        out = [logits]
        for s in range(20, 23):
            logits, cache = model.decode_step(cache, tok[:, s:s + 1],
                                              compute_dtype=torch.bfloat16)
            out.append(logits)
        want = cfg.n_layers if device != "cpu" else 0
        assert flash_attention.launches_sm90 - n90 == want
        assert flash_attention.launches_simt == nsimt
        runs.append([x.cpu() for x in out] + [cache["k"].cpu()])
    for card, cpu in zip(runs[1], runs[0]):
        torch.testing.assert_close(card, cpu, atol=5e-2, rtol=5e-2)


# -- the MoE and recsys serving paths --------------------------------------
SM_CUDA_CASES = [
    # (group sizes, K, N, bm): the kernel tests' cases (padded by
    # pad_segments, empty groups), bm 24 with ragged K / N, and the MoE
    # decode layout (64 experts of C = 8 rows)
    ((128, 256, 128), 64, 128, 128),
    ((0, 512, 128, 0), 32, 256, 128),
    ((100, 30, 250), 48, 128, 128),
    ((64,), 128, 384, 64),
    ((30, 0, 50, 7), 40, 72, 24),
    ((8,) * 64, 256, 176, 8),
    ((200, 137), 130, 100, 136),
]


@pytest.mark.parametrize("case", SM_CUDA_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_segment_matmul_kernel_equals_plain_version(cuda_device, case,
                                                    dtype, tol):
    import numpy as np
    from repro_torch.kernels.segment_matmul.ops import (pad_segments,
                                                        segment_matmul)
    from repro_torch.kernels.segment_matmul.ref import segment_matmul_ref
    sizes, K, N, bm = case
    r = np.random.default_rng(K + N)
    x = r.standard_normal((sum(sizes), K)).astype(np.float32)
    xp, groups, _ = pad_segments(x, np.array(sizes), bm=bm)
    xp = torch.as_tensor(xp).to(cuda_device, dtype)
    w = torch.as_tensor(r.standard_normal((len(sizes), K, N)),
                        dtype=torch.float32).to(cuda_device, dtype)
    n = segment_matmul.launches
    got = segment_matmul(xp, w, groups)               # host ids: checked
    got_dev = segment_matmul(xp, w, torch.as_tensor(groups).to(cuda_device))
    torch.cuda.synchronize()
    assert segment_matmul.launches == n + 2
    assert torch.equal(got, got_dev)
    want = segment_matmul_ref(xp, w, torch.as_tensor(groups))
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


def test_segment_matmul_kernel_marks_bad_group_ids(cuda_device):
    from repro_torch.kernels.segment_matmul.ops import segment_matmul
    x = torch.ones(16, 32, device=cuda_device)
    w = torch.ones(2, 32, 8, device=cuda_device)
    y = segment_matmul(x, w, torch.tensor([1, 5], dtype=torch.int32,
                                          device=cuda_device))
    assert bool((y[:8] == 32).all()) and bool(torch.isnan(y[8:]).all())


def _assert_kernel_close(got, want, dtype: str) -> None:
    """``got`` against ``want`` under ``chip_smoke.KERNEL_TOL[dtype]``:
    per element ``atol_rel * rms(want) + rtol * |want|``, relative L2
    ``rel_l2_max``."""
    tol = _kernel_tol(dtype)
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rms = float(want.pow(2).mean().sqrt())
    assert bool(torch.isfinite(got).all())
    assert bool((err <= tol["atol_rel"] * rms
                 + tol["rtol"] * want.abs()).all()), float(err.max())
    assert float((got - want).norm() / want.norm()) <= tol["rel_l2_max"]


# the CUDA-core flash kernel at chip_smoke.FLASH_SIMT_SHAPES: (dtype, B,
# Sq, Skv, Hq, Hkv, D, causal, window, softcap); q x 8 where there is a
# softcap, so the scores reach it
FA_SIMT_SHAPES = [
    ("float32", 1, 1000, 1003, 8, 4, 16, True, 0, 0.0),
    ("float32", 1, 1000, 1003, 8, 4, 32, True, 256, 0.0),
    ("float32", 1, 1000, 1003, 8, 4, 64, True, 0, 30.0),
    ("float32", 1, 1000, 1003, 8, 4, 128, False, 0, 0.0),
    ("float32", 1, 1000, 1003, 8, 4, 256, True, 0, 0.0),
    ("bfloat16", 1, 1000, 1003, 8, 4, 16, True, 0, 0.0),
    ("bfloat16", 1, 1000, 1003, 8, 4, 32, False, 0, 0.0),
    ("bfloat16", 1, 1000, 1003, 8, 4, 256, True, 256, 50.0),
    # the f32 check of the MoE architecture: 2 x 1032, 16 / 16 heads
    ("float32", 2, 1032, 1032, 16, 16, 128, True, 0, 0.0),
]


@pytest.mark.parametrize("case", FA_SIMT_SHAPES)
def test_simt_flash_kernel_at_ragged_shapes(cuda_device, case):
    """Every head dim in f32, the bf16 head dims the sm90 kernel leaves
    to it, Sq 1000 against Skv 1003, GQA 2:1, a window and a softcap:
    one CUDA-core launch each, held to the plain version under the
    smoke run's limits."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    dt, B, Sq, Skv, Hq, Hkv, D, causal, window, cap = case
    g = torch.Generator(device=cuda_device).manual_seed(Sq + D)
    q, k, v = (torch.randn(s, generator=g, device=cuda_device)
               for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    dtype = getattr(torch, dt)
    q, k, v = (q * (8 if cap else 1)).to(dtype), k.to(dtype), v.to(dtype)
    kw = dict(causal=causal, window=window, attn_softcap=cap)
    n = flash_attention.launches_simt
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches_simt == n + 1
    _assert_kernel_close(got, flash_attention_ref(q, k, v, **kw), dt)


def test_simt_flash_kernel_reads_unaligned_views(cuda_device):
    """f32 views whose rows are not 16-byte aligned (a base one float
    off, a head stride of D + 1) are copied before the CUDA-core kernel
    reads them with 16-byte loads."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    g = torch.Generator(device=cuda_device).manual_seed(7)
    B, S, H, D = 1, 200, 4, 64
    base = torch.randn(3 * B * S * H * (D + 1) + 1, generator=g,
                       device=cuda_device)
    q, k, v = (base[1 + i * B * S * H * (D + 1):][:B * S * H * (D + 1)]
               .view(B, S, H, D + 1)[..., :D] for i in range(3))
    n = flash_attention.launches_simt
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches_simt == n + 1
    _assert_kernel_close(got, flash_attention_ref(q, k, v, causal=True),
                         "float32")


# the f32 grouped GEMM at the f32 check's products and
# chip_smoke.SM_F32_SHAPES: (E, C, K, N)
SM_F32_SHAPES = [(64, 2072, 2048, 1408), (64, 2072, 1408, 2048),
                 (64, 8, 2048, 1408), (8, 136, 1000, 1003)]


@pytest.mark.parametrize("case", SM_F32_SHAPES)
def test_f32_segment_matmul_kernel_at_path_shapes(cuda_device, case):
    """The f32 kernel (one launch) against the plain version under the
    smoke run's f32 limits: gate/up and down at C = 2072, C = 8, and
    K = 1000, N = 1003, where no load is 16 bytes."""
    from repro_torch.kernels.segment_matmul.ops import segment_matmul
    from repro_torch.kernels.segment_matmul.ref import segment_matmul_ref
    E, C, K, N = case
    g = torch.Generator(device=cuda_device).manual_seed(C + K)
    x = torch.randn((E * C, K), generator=g, device=cuda_device)
    w = torch.randn((E, K, N), generator=g, device=cuda_device) * K ** -0.5
    groups = torch.arange(E, dtype=torch.int32, device=cuda_device)
    n = segment_matmul.launches_simt
    got = segment_matmul(x, w, groups)
    torch.cuda.synchronize()
    assert segment_matmul.launches_simt == n + 1
    _assert_kernel_close(got, segment_matmul_ref(x, w, groups), "float32")


def test_f32_segment_matmul_marks_one_bad_block(cuda_device):
    """An id out of range on the card turns its block (136 rows, K 1000,
    N 1003) to NaN and leaves every other block as the valid ids give."""
    from repro_torch.kernels.segment_matmul.ops import segment_matmul
    E, C, K, N = 8, 136, 1000, 1003
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn((E * C, K), generator=g, device=cuda_device)
    w = torch.randn((E, K, N), generator=g, device=cuda_device)
    groups = torch.arange(E, dtype=torch.int32, device=cuda_device)
    bad = groups.clone()
    bad[3] = E
    good, got = segment_matmul(x, w, groups), segment_matmul(x, w, bad)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[3 * C:4 * C]).all())
    assert torch.equal(got[:3 * C], good[:3 * C])
    assert torch.equal(got[4 * C:], good[4 * C:])


def _sm_inputs(device, sizes, K, N, bm, seed):
    """Padded bf16 rows and weights of one case, made from a numpy seed."""
    import numpy as np
    from repro_torch.kernels.segment_matmul.ops import pad_segments
    r = np.random.default_rng(seed)
    x = r.standard_normal((sum(sizes), K)).astype(np.float32)
    xp, groups, _ = pad_segments(x, np.array(sizes), bm=bm)
    w = r.standard_normal((len(sizes), K, N)).astype(np.float32) * K ** -0.5
    return (torch.as_tensor(xp).to(device, torch.bfloat16),
            torch.as_tensor(w).to(device, torch.bfloat16),
            torch.as_tensor(groups))


def _assert_bf16_close(got, want):
    """The smoke run's bf16 limits (``chip_smoke.KERNEL_TOL``): both
    accumulate in f32 and round once, so they differ by at most an ulp."""
    tol = _kernel_tol("bfloat16")
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rms = float(want.pow(2).mean().sqrt())
    assert bool(torch.isfinite(got).all())
    assert bool((err <= tol["atol_rel"] * rms + tol["rtol"] * want.abs())
                .all()), float(err.max())
    assert float((got - want).norm() / want.norm()) <= tol["rel_l2_max"]


# (group sizes, K, N, bm): the cases of SM_CUDA_CASES whose K and N the
# sm90 kernel takes, a ragged segment of two row tiles per expert (the MoE
# layout, C = 200), and a decode step's layout at Qwen1.5-MoE's widths
# (64 experts of C = 8 rows, K 2048, N 1408)
SM90_CUDA_CASES = [
    *[c for c in SM_CUDA_CASES if c[1] % 8 == 0 and c[2] % 8 == 0],
    ((200,) * 4, 256, 384, 200),
    ((8,) * 64, 2048, 1408, 8),
]


@pytest.mark.parametrize("case", SM90_CUDA_CASES)
def test_sm90_segment_matmul_kernel_equals_plain_version(cuda_device, case):
    """bf16 with K and N multiples of 8 goes through the wgmma kernel
    (one sm90 launch, none of the other kernel) and agrees with the plain
    version under the smoke run's bf16 limits, with the group ids on the
    host and on the card."""
    from repro_torch.kernels.segment_matmul.ops import segment_matmul
    from repro_torch.kernels.segment_matmul.ref import segment_matmul_ref
    sizes, K, N, bm = case
    x, w, groups = _sm_inputs(cuda_device, sizes, K, N, bm, seed=K + N)
    n90, nsimt = segment_matmul.launches_sm90, segment_matmul.launches_simt
    got = segment_matmul(x, w, groups)
    got_dev = segment_matmul(x, w, groups.to(cuda_device))
    torch.cuda.synchronize()
    assert segment_matmul.launches_sm90 == n90 + 2
    assert segment_matmul.launches_simt == nsimt
    assert torch.equal(got, got_dev)
    _assert_bf16_close(got, segment_matmul_ref(x, w, groups))


def test_sm90_segment_matmul_reads_unaligned_views(cuda_device):
    """Views TMA cannot read as they are (a base 2 bytes off 16, w with
    N strided) are copied first; a row view at a 16-byte offset is read
    in place."""
    from repro_torch.kernels.segment_matmul.ops import (segment_matmul,
                                                        tma_ready)
    from repro_torch.kernels.segment_matmul.ref import segment_matmul_ref
    x, w, groups = _sm_inputs(cuda_device, (100, 30, 250), 64, 192, 128, 7)
    M, K = x.shape
    flat = torch.empty(M * K + 1, dtype=x.dtype, device=cuda_device)
    off = flat[1:].view(M, K)                          # 2-byte offset
    off.copy_(x)
    wt = w.transpose(1, 2).contiguous().transpose(1, 2)   # N strided
    rows = torch.cat([x[:1], x])[1:]                   # 128-byte offset
    assert not tma_ready(off) and not tma_ready(wt) and tma_ready(rows)
    want = segment_matmul_ref(x, w, groups)
    for xs, ws in ((off, w), (x, wt), (rows, w)):
        n90 = segment_matmul.launches_sm90
        got = segment_matmul(xs, ws, groups)
        torch.cuda.synchronize()
        assert segment_matmul.launches_sm90 == n90 + 1
        _assert_bf16_close(got, want)


@pytest.mark.parametrize("bm", [8, 128])
def test_sm90_segment_matmul_marks_bad_group_ids(cuda_device, bm):
    """A segment whose id is out of range is written as NaN in both tile
    configurations (decode bm < 64, prefill bm >= 64); its neighbour is
    right."""
    from repro_torch.kernels.segment_matmul.ops import segment_matmul
    x = torch.ones(2 * bm, 32, dtype=torch.bfloat16, device=cuda_device)
    w = torch.ones(2, 32, 8, dtype=torch.bfloat16, device=cuda_device)
    n90 = segment_matmul.launches_sm90
    y = segment_matmul(x, w, torch.tensor([1, 5], dtype=torch.int32,
                                          device=cuda_device))
    torch.cuda.synchronize()
    assert segment_matmul.launches_sm90 == n90 + 1
    assert bool((y[:bm] == 32).all()) and bool(torch.isnan(y[bm:]).all())


def test_segment_matmul_odd_width_bf16_takes_the_simt_kernel(cuda_device):
    """bf16 with K = 36 (no 16-byte rows for TMA) launches the mma.sync
    kernel once and the sm90 kernel not at all."""
    from repro_torch.kernels.segment_matmul.ops import segment_matmul
    from repro_torch.kernels.segment_matmul.ref import segment_matmul_ref
    x, w, groups = _sm_inputs(cuda_device, (100, 30, 250), 36, 128, 128, 9)
    n, n90, nsimt = (segment_matmul.launches, segment_matmul.launches_sm90,
                     segment_matmul.launches_simt)
    got = segment_matmul(x, w, groups)
    torch.cuda.synchronize()
    assert (segment_matmul.launches, segment_matmul.launches_sm90,
            segment_matmul.launches_simt) == (n + 1, n90, nsimt + 1)
    _assert_bf16_close(got, segment_matmul_ref(x, w, groups))


def test_segment_matmul_simt_timing_entry_takes_sm90_widths(cuda_device):
    """``_segment_matmul_simt`` runs the mma.sync kernel on work the
    wrapper would give the sm90 kernel, and both agree with the plain
    version."""
    from repro_torch.kernels.segment_matmul.ops import (
        _segment_matmul_simt, segment_matmul)
    from repro_torch.kernels.segment_matmul.ref import segment_matmul_ref
    x, w, groups = _sm_inputs(cuda_device, (200,) * 4, 256, 384, 200, 11)
    nsimt, n90 = segment_matmul.launches_simt, segment_matmul.launches_sm90
    got = _segment_matmul_simt(x, w, groups)
    torch.cuda.synchronize()
    assert segment_matmul.launches_simt == nsimt + 1
    assert segment_matmul.launches_sm90 == n90
    _assert_bf16_close(got, segment_matmul_ref(x, w, groups))


EB_CUDA_CASES = [
    # (V, d, B, bag, with_weights, pad_fraction): the kernel tests' cases,
    # DCN-v2's row width, a width with no 16-byte loads, a wide row
    (64, 16, 8, 1, False, 0.0),
    (256, 32, 16, 4, True, 0.3),
    (1024, 128, 4, 8, True, 0.5),
    (32, 8, 32, 2, False, 0.2),
    (5000, 16, 3000, 1, False, 0.1),
    (100, 13, 50, 5, True, 0.3),
    (300, 520, 20, 3, True, 0.0),
    # one bag; one bag past a multiple of a block's batch (128 / tpr bags
    # a round, 4 rounds a batch for bags of one: 256 bags in bf16, 128 in
    # f32); long bags, half pads (slots in groups of 8); every bag all pads
    (64, 16, 1, 1, False, 0.0),
    (5000, 16, 2049, 1, False, 0.1),
    (1000, 16, 300, 100, True, 0.5),
    (64, 16, 40, 3, True, 1.0),
]


@pytest.mark.parametrize("case", EB_CUDA_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_embedding_bag_kernel_equals_plain_version(cuda_device, case, dtype,
                                                   tol, idx_dtype):
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    V, d, B, bag, with_w, pad = case
    g = torch.Generator(device=cuda_device).manual_seed(V + d)
    table = torch.randn((V, d), generator=g, device=cuda_device).to(dtype)
    idx = torch.randint(0, V + 3, (B, bag), generator=g, device=cuda_device)
    idx[torch.rand((B, bag), generator=g, device=cuda_device) < pad] = -1
    idx = idx.to(idx_dtype)
    w = (torch.randn((B, bag), generator=g, device=cuda_device)
         if with_w else None)
    n = embedding_bag.launches
    got = embedding_bag(table, idx, w)
    torch.cuda.synchronize()
    assert embedding_bag.launches == n + 1
    want = embedding_bag_ref(table, idx, w)
    if bag == 1:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("bag", [1, 4])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
def test_embedding_bag_kernel_on_a_misaligned_table_view(cuda_device, dtype,
                                                         tol, bag):
    """A table view one element into its buffer: rows of 16 elements, but
    no 16-byte loads (the one-element path), against the plain version."""
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    V, d, B = 700, 16, 900
    g = torch.Generator(device=cuda_device).manual_seed(17)
    flat = torch.randn(V * d + 1, generator=g, device=cuda_device).to(dtype)
    table = flat[1:].view(V, d)
    assert table.data_ptr() % 16 != 0
    idx = torch.randint(-1, V, (B, bag), generator=g, device=cuda_device)
    w = torch.randn((B, bag), generator=g, device=cuda_device)
    n = embedding_bag.launches
    got = embedding_bag(table, idx, None if bag == 1 else w)
    torch.cuda.synchronize()
    assert embedding_bag.launches == n + 1
    want = embedding_bag_ref(table, idx, None if bag == 1 else w)
    if bag == 1:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("bag", [1, 4])
def test_embedding_bag_f32_output_with_int32_ids(cuda_device, bag):
    """The f32-output mode (a row-sharded table's partial bags) with
    int32 ids and ``-1`` pads: the f32 sums against the plain version's
    (bit for bit for bags of one), and rounded, the bf16 output."""
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    V, d, B = 4000, 16, 5000
    g = torch.Generator(device=cuda_device).manual_seed(19)
    table = torch.randn((V, d), generator=g,
                        device=cuda_device).to(torch.bfloat16)
    idx = torch.randint(-1, V, (B, bag), generator=g,
                        device=cuda_device).to(torch.int32)
    w = None if bag == 1 else torch.randn((B, bag), generator=g,
                                          device=cuda_device)
    n = embedding_bag.launches
    got = embedding_bag(table, idx, w, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert embedding_bag.launches == n + 1 and got.dtype == torch.float32
    want = embedding_bag_ref(table, idx, w, out_dtype=torch.float32)
    if bag == 1:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(got.to(torch.bfloat16), embedding_bag(table, idx, w))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
def test_card_moe_lm_equals_cpu(cuda_device, arch, dtype, tol):
    """Prefill and 3 decode steps, card against CPU on the same numpy
    weights; f32 without TF32.  In bf16 the CPU run's routes are handed
    to the card run (a near tie may route differently on the two devices;
    see tests/test_torch_moe_lm.py), and where the card's own top-k
    differs the helper asserts a near tie."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.testing import compare, moe_lm_runs
    cfg = get_smoke_config(arch)
    runs, launches, _ = moe_lm_runs(arch, dtype, seed=3, device=cuda_device)
    assert launches[0] == dict(flash_attention=0, segment_matmul=0,
                               embedding_bag=0)
    assert launches[1] == dict(flash_attention=cfg.n_layers,
                               segment_matmul=3 * 4 * cfg.n_layers,
                               embedding_bag=0)
    compare(runs, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
def test_card_recsys_equals_cpu(cuda_device, dtype, tol):
    """DCN-v2 smoke config: forward (one-hot and multi-hot) and
    retrieval, card against CPU; f32 without TF32."""
    from repro_torch.testing import compare, recsys_runs
    runs, launches = recsys_runs(dtype, seed=5, device=cuda_device)
    assert launches[0] == dict(flash_attention=0, segment_matmul=0,
                               embedding_bag=0)
    assert launches[1] == dict(flash_attention=0, segment_matmul=0,
                               embedding_bag=3)
    compare(runs, tol)


@pytest.mark.parametrize("name", ["gat-cora", "gatedgcn", "graphsage-reddit",
                                  "graphsage-reddit-blocks", "graphcast",
                                  "dcn-v2"])
def test_card_train_steps_equal_cpu(cuda_device, name):
    """Three AdamW steps of each smoke training case, card against CPU
    from the same numpy weights and batches: f32 GNNs 1e-4 (scatter
    order differs on the card), DCN-v2 (bf16 forward) 5e-2; DCN-v2
    launches the EmbeddingBag kernel once per step on the card."""
    from repro_torch.testing import compare_train, train_runs
    runs, launches = train_runs(name, device=cuda_device)
    compare_train(runs, 5e-2 if name == "dcn-v2" else 1e-4)
    assert launches[0]["embedding_bag"] == 0
    assert launches[1]["embedding_bag"] == (3 if name == "dcn-v2" else 0)


@pytest.mark.parametrize("arch", ["granite-8b", "gemma2-27b", "deepseek-7b",
                                  "qwen2-moe-a2.7b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
def test_card_lm_train_equals_cpu(cuda_device, arch, dtype, tol):
    """An LM smoke config's first loss and gradient, then three AdamW
    steps, card against CPU from the same numpy tree and batches (f32
    without TF32; in bf16 an MoE config's routes pinned to the CPU's).
    Per step the card launches the flash kernel twice a layer (the
    forward and the remat recompute) and the grouped GEMM nine times a
    MoE layer (three products, recomputed, and three dX)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.testing import compare_lm_train, lm_train_runs
    cfg = get_smoke_config(arch)
    runs, _ = lm_train_runs(arch, dtype, device=cuda_device)
    compare_lm_train(runs, tol)
    assert runs[0]["launches"] == dict(flash_attention=0, segment_matmul=0,
                                       embedding_bag=0)
    assert runs[1]["launches"] == dict(
        flash_attention=2 * cfg.n_layers,
        segment_matmul=9 * cfg.n_layers * cfg.is_moe, embedding_bag=0)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_embedding_bag_backward_on_card_equals_plain_autograd(
        cuda_device, dtype, tol, weighted):
    """The table gradient through the kernel's autograd seam (forward:
    the CUDA kernel; backward: ``index_add_`` in f32, cast once) against
    the autograd of ``embedding_bag_ref`` on the f32 table, cast once, on
    the card."""
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.models import recsys
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    V, d, B, bag = 5000, 16, 4096, 4
    table = torch.randn((V, d), generator=gen, device=cuda_device).to(dtype)
    idx = torch.randint(0, V, (B, bag), generator=gen, device=cuda_device)
    idx[torch.rand((B, bag), generator=gen, device=cuda_device) < 0.2] = -1
    w = (torch.randn((B, bag), generator=gen, device=cuda_device)
         if weighted else None)
    g = torch.randn((B, d), generator=gen, device=cuda_device).to(dtype)
    t1 = table.clone().requires_grad_()
    n = embedding_bag.launches
    recsys.embedding_bag(t1, idx, w).backward(g)
    assert embedding_bag.launches == n + 1
    t2 = table.float().requires_grad_()     # f32 sums, rounded once
    embedding_bag_ref(t2, idx, w).backward(g.float())
    want = t2.grad.to(dtype).float()
    torch.testing.assert_close(t1.grad.float(), want, rtol=tol,
                               atol=tol * float(want.abs().max()))


def _mesh_vs_meshless(device, tmp_path, arch, dims, backend):
    """``train_loss`` and its gathered gradient on a model mesh of ranks
    on the card (``run_on_mesh``) against the meshless card run, f32
    (no TF32), sequence parallel where the model axis is > 1: the loss
    and every leaf within 1e-5 in relative L2."""
    from functools import partial

    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.models import transformer
    from repro_torch.models.convert import numpy_params, tree_from_numpy
    from repro_torch.testing import lm_batch
    from repro_torch.train import pytree
    from repro_torch.train.steps import value_and_grad
    from torch_dist_workers import lm_grads
    cfg = get_smoke_config(arch)
    params = numpy_params(cfg, seed=0)
    batch = lm_batch(cfg, np.random.default_rng(1), B=4)
    case = dict(arch=arch, dims=dims, sp=dims[1] > 1, dtype="float32",
                params=params, batch=batch, device="cuda", backend=backend)
    got = run_on_mesh(lm_grads, dims[0] * dims[1],
                      str(tmp_path / "rendezvous"), args=([case],),
                      timeout_s=300)[0][0]
    loss, grads = value_and_grad(partial(
        transformer.train_loss, cfg, compute_dtype=torch.float32))(
        tree_from_numpy(params, device=device),
        {k: torch.as_tensor(v, device=device) for k, v in batch.items()})
    assert got["loss"] == pytest.approx(float(loss), rel=1e-5)
    for a, b in zip(got["grads"], pytree.leaves(grads), strict=True):
        b = b.float().cpu().numpy()
        assert np.linalg.norm(a - b) <= 1e-5 * max(np.linalg.norm(b),
                                                    1e-30)


@pytest.mark.parametrize("arch", ["granite-8b", "granite-moe-3b-a800m"])
def test_mesh_of_one_rank_over_nccl_equals_meshless(cuda_device, tmp_path,
                                                   arch):
    _mesh_vs_meshless(cuda_device, tmp_path, arch, (1, 1), "nccl")


@pytest.mark.parametrize("dims", [(2, 2), (4, 1)])
def test_mesh_over_nccl_one_card_per_rank_equals_meshless(
        cuda_device, tmp_path, dims):
    """NCCL refuses two ranks on one card: this runs where the machine
    has a card per rank."""
    if torch.cuda.device_count() < dims[0] * dims[1]:
        pytest.skip(f"{dims[0] * dims[1]} ranks need as many cards")
    _mesh_vs_meshless(cuda_device, tmp_path, "granite-moe-3b-a800m", dims,
                      "nccl")


def test_mesh_over_gloo_sharing_one_card_equals_meshless(cuda_device,
                                                         tmp_path):
    """Four ranks on the one card over gloo (it copies CUDA tensors
    through the host), ``(data=2, model=2)`` with sequence parallelism:
    both kernels at each rank's shapes."""
    _mesh_vs_meshless(cuda_device, tmp_path, "granite-moe-3b-a800m", (2, 2),
                      "gloo")


def test_card_stage_spans_carry_device_times(cuda_device):
    """At obs level ``trace`` a card run equals its untraced run, and
    every stage span of its chunks carries a positive ``device_ms`` from
    its CUDA events, read after the window's host copy (two cohorts:
    M5-2/M5-3 of two lanes, M5-4 alone; four chunks each)."""
    from repro_torch import estimate_many, obs
    g = powerlaw_temporal_graph(**GRAPH)
    jobs = [(m, 2000, 1024, 0) for m in ("M5-2", "M5-3", "M5-4")]
    plain = estimate_many(g, jobs, chunk=256, device=cuda_device)
    obs.set_level("trace")
    obs.RECORDER.clear()
    try:
        traced = estimate_many(g, jobs, chunk=256, device=cuda_device)
        recs = obs.RECORDER.records()
    finally:
        obs.set_level(None)
        obs.RECORDER.clear()
    for a, b in zip(plain, traced):
        for f in FIELDS + ("fused_jobs",):
            assert getattr(a, f) == getattr(b, f), f
    by = {}
    for r in recs:
        by.setdefault(r["name"], []).append(r)
    assert [len(by[n]) for n in ("sampler.draw", "validate.lane")] \
        == [8, 12]
    for name in ("sampler.draw", "validate.lane"):
        assert all(r["device_ms"] > 0 and "error" not in r
                   for r in by[name]), name

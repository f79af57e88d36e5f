#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py            # from the root of a checkout

Builds the hand-written CUDA kernels, holds each against its plain torch
version on the card at the shapes of its main path, and drives the
port's two paths:

* TIMEST: card against CPU on a small graph, then one full-size estimate
  through ``repro_torch.estimate``, the one-shot-Session shim (``api.
  Session`` -> ``core.batch.BatchPlanner`` -> ``core.engine.run_plan``),
  shown to launch the dep-sum (interval-weight) kernel once per dep-sum
  and the tree-sampler kernel, which draws its own threefry bits, once
  per chunk;
* the TIMEST estimation service at full size: a tree cohort of three
  motifs x two seeds through one ``Session.submit_many``, shown to
  launch the sampler once per chunk for both seed streams, every cell
  equal to its solo ``estimate()``; a checkpoint written at k / 2 and
  resumed to k; three NDJSON requests through ``serve_loop``; and, on a
  mid-size graph, the estimate's relative error against ``count_exact``
  (a reading);
* the multi-tenant gateway at full size (``gateway_serve_loop`` on a
  thread of this process, obs at ``trace``): a tenant on the full graph
  answers phase ``full``'s integers and a witness request; a stream
  tenant with a WAL answers each epoch as a direct ``StreamingSession``
  and recovers on reopen; three injected dispatch faults are retried and
  the window halved, the integers unchanged; a profile armed over the
  wire holds the sampler kernel; the trace chains one request across
  the gateway's threads; the same wire script gives equal answers on a
  ``cpu`` and a ``cuda`` gateway;
* LM serving: card against CPU for the Gemma-2 smoke config, then
  Gemma-2-27B at full width (random bf16 weights from seed 0): a
  2 x 8192-token prefill and 16 greedy decode steps, shown to go through
  the sm90 flash-attention kernel (wgmma + TMA) in every prefill layer;
* MoE LM serving: card against CPU for both MoE smoke configs, then
  Qwen1.5-MoE-A2.7B at full width and depth (random bf16 weights from
  seed 0, the config's capacity factor 1.25): a 2 x 8192-token prefill and
  16 greedy decode steps, shown to go through the sm90 grouped-GEMM
  kernel (wgmma + TMA) in every expert product, prefill and decode, and
  the sm90 flash kernel in every prefill layer; then the same
  architecture in f32 with no capacity drops, prefill against decode,
  through the CUDA-core kernels of both (f32);
* recsys serving: card against CPU for the DCN-v2 smoke config, then
  DCN-v2 at full width (the Criteo-1TB table profile, 62,988,288 rows of
  16 in bf16): the serve_p99, serve_bulk and retrieval_cand traffic of
  ``configs/shapes.py``, shown to go through the EmbeddingBag kernel;
* training: card against CPU for three AdamW steps of the smoke GNNs
  (GAT, GatedGCN on molecules, GraphSAGE on a graph and on sampled
  blocks, GraphCast) and DCN-v2, and a DCN-v2 ``run_resumable`` killed
  after step 2 and resumed, equal to the straight run; the four GNN
  configs at full width on a ``GNN_SHAPES`` cell each (the sampler over
  the minibatch_lg graph's 114.6 M edges); DCN-v2 at full width in
  training (f32 table and AdamW state on the card, train_batch 65,536),
  one EmbeddingBag launch a step, its backward held against the plain
  autograd; and ``examples/motif_features_gnn.py``'s pipeline, TIMEST
  motif features from ``Session.sample_matches`` (both TIMEST kernels,
  card == CPU) feeding a GraphSAGE classifier trained on the card;
* LM training: card against CPU for the five LM smoke configs (first
  loss, every gradient leaf, three AdamW steps, f32 and bf16) and a
  killed-and-resumed run equal to the straight one;
  ``examples/train_lm.py``'s ~100 M model for 60 steps (the loss falls,
  a run resumed from step 30 matches); granite-moe-3b-a800m at full
  width on one card (f32 state, bf16 compute, remat), cut in depth to
  what the measured peak allows, train_4k sequences with accumulation
  4: each step launches the sm90 flash kernel (forward and recompute)
  and the sm90 grouped GEMM (forward, recompute and dX), a 2-layer f32
  check card against CPU, and both kernels held against their plain
  versions at this path's shapes;
* LM training on a model mesh: the same model on ``make_host_mesh(
  data=2, model=2)``, four spawned ranks over gloo sharing the one card
  (NCCL refuses two ranks on one card), sequence parallel and ZeRO,
  train_4k sequences one per data rank per microbatch, accumulation 4,
  2 steps at 4 layers (cuts for the run's time): each rank launches the
  sm90 flash kernel and the sm90 grouped GEMM at its own shapes (12 / 4
  heads, 24 of 48 experts); step 1 against one process, a 2-layer f32
  check four ranks against one process, ``(1, 1)`` over NCCL against one
  process, ``(2, 2)`` over NCCL where there are four cards.
* the rest of the model mesh, each on four gloo ranks sharing the card:
  the reference's sharded GNN cells at minibatch_lg (gatedgcn, graphcast
  grid-sharded, gat-cora) trained edge-parallel on ``(data=4, model=1)``,
  step 1 against one process (phase ``gnn_train_dist``); DCN-v2 at full
  size on ``(data=2, model=2)``, the table sharded by rows and looked up
  through the EmbeddingBag kernel on each rank's rows (one launch a rank
  a step), step 1 against one process, serve_bulk and retrieval_cand
  bit-equal to one process, the sharded quantizer bit-equal to the
  meshless one on the table gradient, the kernel at a rank's shapes
  (phase ``recsys_train_dist``); GPipe on ``(pod=4, data=1, model=1)``
  at width 4096 against serial application (phase ``pipeline``).
* the roofline (phase ``roofline``, on the host, no card work): the dry
  run of ``repro_torch.launch.dryrun`` -- rank 0's step counted on meta
  tensors (``roofline.cost``) on a ``(1, 1)`` layout -- for the cells
  this run drives uncut on the card (DCN-v2 train_batch, serve_p99,
  serve_bulk, retrieval_cand; the four ``GNN_CELLS``), each cell's H100
  roofline terms beside the step or call time phases ``recsys_full``,
  ``recsys_train`` and ``gnn_train`` measured, and their ratio.

The GNN cells' configs (fanouts, remat groups), widths and batch layouts
come from ``repro_torch.launch.specs.build_cell``; the smoke generates
only their numpy data and requires it to match the cell's layout.

Each phase prints one JSON line; then a ``{"phase_seconds": ...}`` line
(the wall time of each phase call in ``main``), the ``kernels`` record
and, last, ``{"ok": true, "device": ...}``.
Any mismatch or error exits non-zero without that line.  Without a CUDA
device, or outside a checkout of the repository, it fails at once.

TIMEST full size: a power-law temporal graph at the scale of SNAP's
wiki-talk-temporal (1,140,149 nodes, 7,833,140 temporal edges, 2,320 days
in seconds), motif M5-3, delta 3600, k = 2^20, chunk 8192, seed 0.  The
service phase runs on the same graph and delta.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
FULL_GRAPH = ("powerlaw:n=1140149,m=7833140,alpha=2.1,"
              "time_span=200448000,seed=0")
SMALL_GRAPH = "powerlaw:n=150,m=2000,time_span=40000,seed=11"
# (motif, delta, k, seed) on SMALL_GRAPH with chunk 256, and the JAX
# reference's result there (repro.core.estimator.estimate under jax's
# default threefry mode): W, cnt2_sum, valid
SMALL_CASES = (("M5-3", 3000, 1024, 0, (412857, 20, 446)),
               ("M4-2", 3000, 512, 3, (640115, 557, 395)))
# wider windows for the full graph until W passes 2^32 (a day, a week,
# a month): the tree sampler's draws then wrap as jax's do
WIDE_DELTAS = (86400, 604800, 2592000)
# the service phase's tree cohort (one min-W tree signature on the full
# graph at delta 3600, as on the small graph at 3000) and its seeds
COHORT, COHORT_SEEDS = ("M5-2", "M5-3", "M5-4"), (0, 1)
# the oracle reading: SNAP wiki-talk's edge density (7.8 M edges over
# 2.0e8 s) at 200 k edges, and (motif, delta) cases whose exact count
# takes seconds there (count_exact: 6 s and 5 s on a CPU core)
ORACLE_GRAPH = "powerlaw:n=20000,m=200000,alpha=2.1,time_span=5120000,seed=0"
ORACLE_CASES = (("M4-2", 3600), ("M5-2", 3600))
# the live-stream phases' standing queries: (motif, delta, k, seed,
# witnesses) on SMALL_GRAPH in 4 batches with horizon 20000 (card against
# CPU); (motif, delta, seed, witnesses) at k = min(STREAM_K, --k) on the
# full graph in 8 batches with horizon span / 4 and a WAL
STREAM_SMALL = (("M5-3", 3000, 1024, 0, 0), ("M4-2", 3000, 512, 3, 8))
STREAM_QUERIES = (("M5-3", 3600, 0, 0), ("M4-2", 3600, 0, 8))
STREAM_K, STREAM_BATCHES, STREAM_RECOVER_AT = 1 << 18, 8, 5
# the gateway phase's stream tenant: two batches of this many edges
GATEWAY_BATCH = 65536
FIELDS = ("estimate", "W", "k", "cnt2_sum", "valid", "fail_vmap",
          "fail_delta", "fail_order", "overflow", "tree_edges")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
OPS_PER_S = 67e12             # H100 SXM non-tensor fp32 rate, used for
                              # the integer compare/select/add work
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores
F32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
# H100 SXM special-function units (ex2, rcp): 16 results a clock on each
# of 132 SMs, at the 1.83 GHz where 989 TFLOP/s holds
SFU_OPS_PER_S = 132 * 16 * 1.83e9
# the LM path: Gemma-2-27B serving 2 prompts of 8192 tokens
LM_ARCH, LM_BATCH, LM_PROMPT, LM_DECODE, LM_CHECK_AT = (
    "gemma2-27b", 2, 8192, 16, 8)
# kernel against its plain version, bf16 at the path's shapes: per element
# |err| <= FA_ATOL + FA_RTOL |want| (about two bf16 ulps at any size; the
# outputs there have an rms of ~0.05, so an atol of 2e-2 would be as large
# as what it compares), and over the whole output relative L2 <= FA_REL_L2
# (about one bf16 rounding of the output); the faults the phase reads must
# move the output by at least FA_FAULT_MIN.  The sm90 kernel and its plain
# version both round p to bf16, and where a p sits at a rounding boundary
# their f32 sum orders may round it either way: each element also gets
# repro_torch.testing.p_rounding_allowance (~0 where the softmax is flat)
FA_ATOL, FA_RTOL, FA_REL_L2, FA_FAULT_MIN = 4e-3, 2e-2, 2e-3, 2e-2
# prefill(prompt + first 8 generated tokens) against decode step 8, in
# relative L2 of the logits: two bf16 evaluation orders through 46
# layers (both round p to bf16 as the reference does, at different
# running maxima; the products are batched differently), so they agree
# to about bf16's relative precision times the depth's growth, not bit
# for bit
LM_CHECK_TOL = 5e-2
# the MoE path: Qwen1.5-MoE-A2.7B serving 2 prompts of 8192 tokens; its
# check runs the same architecture in f32 with capacity factor
# n_experts / top_k (no drops) on 2 prompts of 1024 tokens
MOE_ARCH, MOE_CHECK_PROMPT, MOE_CHECK_AT = "qwen2-moe-a2.7b", 1024, 8
# prefill(prompt + 8 generated) against decode step 8 in f32: summation
# order only (the dense f32 smoke configs agree to ~4e-6 on the CPU)
MOE_CHECK_TOL = 1e-3
# kernel against its plain version: per element |err| <= atol_rel *
# rms(want) + rtol * |want| (the absolute part read from the output's own
# scale), relative L2 <= rel_l2_max; each fault the phase reads must move
# the output by at least 10 x rel_l2_max.  bf16: both accumulate in f32
# and round once, so they differ by at most an ulp (2^-8 relative) where
# the f32 sums round to either side; f32: summation order only.
KERNEL_TOL = {"bfloat16": dict(rtol=1e-2, atol_rel=2e-3, rel_l2_max=2e-3),
              "float32": dict(rtol=1e-4, atol_rel=5e-5, rel_l2_max=1e-5)}
FAULT_FACTOR = 10
# the CUDA-core flash kernel beyond the f32 check, each against its plain
# version under KERNEL_TOL[dtype]: (dtype, B, Sq, Skv, Hq, Hkv, D, causal,
# window, softcap); every head dim in f32, the bf16 head dims the sm90
# kernel does not take, Sq = 1000 against Skv = 1003 (ragged both),
# GQA with G = 2, one window, one softcap (q x 8 there: the scores reach
# the cap)
FLASH_SIMT_SHAPES = (
    ("float32", 1, 1000, 1003, 8, 4, 16, True, 0, 0.0),
    ("float32", 1, 1000, 1003, 8, 4, 32, True, 256, 0.0),
    ("float32", 1, 1000, 1003, 8, 4, 64, True, 0, 30.0),
    ("float32", 1, 1000, 1003, 8, 4, 128, False, 0, 0.0),
    ("float32", 1, 1000, 1003, 8, 4, 256, True, 0, 0.0),
    ("bfloat16", 1, 1000, 1003, 8, 4, 16, True, 0, 0.0),
    ("bfloat16", 1, 1000, 1003, 8, 4, 32, False, 0, 0.0),
    ("bfloat16", 1, 1000, 1003, 8, 4, 256, True, 256, 50.0))
# the f32 grouped GEMM beyond the f32 check's products, against its plain
# version under KERNEL_TOL["float32"]: (case, E, C, K, N); the decode
# step's 8 rows an expert, and widths that allow no 16-byte load; the
# last case's block 3 also gets an invalid group id and must come out NaN
SM_F32_SHAPES = (("C = 8", 64, 8, 2048, 1408),
                 ("K = 1000, N = 1003", 8, 136, 1000, 1003))
# training: card against CPU at smoke size (f32 GNNs: the card's scatter
# order differs; DCN-v2: the bf16 tolerance of tests/test_torch_recsys.py),
# and the full-width first step's loss and gradient norm against the CPU
# (the GNN cells and DCN-v2)
TRAIN_SMALL_TOL = {"gnn": 1e-4, "dcn-v2": 5e-2}
TRAIN_FULL_TOL = 1e-3
# DCN-v2's bf16 gradient, each leaf's norm against the f32 CPU's: bf16's
# rtol (KERNEL_TOL), its values rounding at 2^-8 through six layers
BF16_GRAD_TOL = 1e-2
TRAIN_STEPS = 5
# the DCN-v2 cells phase roofline counts beside their card times
ROOFLINE_RECSYS = ("train_batch", "serve_p99", "serve_bulk",
                   "retrieval_cand")
# the GNN cells trained at full width (configs/shapes.py GNN_SHAPES;
# ogb_products waits for the distribution slice: unsharded, its edge
# activations pass the card's 80 GB)
GNN_CELLS = (("gat-cora", "full_graph_sm"),
             ("graphsage-reddit", "minibatch_lg"),
             ("gatedgcn", "molecule"), ("graphcast", "full_graph_sm"))
# LM training: card against CPU at smoke size (f32: summation order and
# the card's scatter order; bf16: the LM tests' bf16 tolerance)
LM_IDS = ("granite-8b", "gemma2-27b", "deepseek-7b", "qwen2-moe-a2.7b",
          "granite-moe-3b-a800m")
LM_TRAIN_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# examples/train_lm.py's ~100 M model (its lm100m() and its settings: batch
# 8, seq 128, accumulation 2, lr 6e-4, warmup 20) for 60 steps, resumed
# from step 30 (200 and 100, then 100 and 50, before: cuts for the run's
# time; the loss must still fall); the resumed run is held to the straight
# one within
# LEARN_RESUME_TOL (relative: each loss, each parameter leaf in L2), as
# the card's scatter-adds may sum in another order from run to run
LEARN = dict(batch=8, seq=128, accum=2, lr=6e-4, warmup=20, steps=60,
             resume_at=30)
LEARN_RESUME_TOL = 1e-3
# granite-moe-3b-a800m trained at full width on one card: train_4k's
# sequence of 4096 tokens, one sequence per microbatch, accumulation 4
# (the reference's launch/specs.py PERF entry for this cell), 2 steps (5,
# then 3, before: cuts for the run's time); the depth is the deepest even
# one
# whose predicted step peak stays FULL_TRAIN_MARGIN below the card's
# memory
FULL_TRAIN = dict(arch="granite-moe-3b-a800m", seq=4096, accum=4, steps=2,
                  check_layers=2)
FULL_TRAIN_MARGIN = 0.06
# the same model on make_host_mesh(data=2, model=2): four ranks over gloo
# sharing the one card (NCCL refuses two ranks on one card), sequence
# parallel and ZeRO (the reference's launch/specs.py PERF entry for this
# cell), train_4k sequences, one per data rank per microbatch,
# accumulation 4 (8 sequences a step), 2 steps at a fixed depth of 4
# layers (cuts for the run's time: 3 steps at the deepest depth the
# four ranks' summed peak let fit, 10, probed at 2 and 4 layers, before;
# the phase's ``reduced``).  Step 1's loss and each leaf's f64 gradient
# norm (bf16 compute) are held to the one-process run within
# TRAIN_FULL_TOL, the norm weights' within DIST_NORM_GRAD_TOL: a norm
# weight's gradient sums 8192 tokens' products with cancellation, and the
# ranks round their partial sums apart (on the H100 at 700 W up to
# 1.59e-3 there, at most 4e-4 on every other leaf); the 2-layer cut in
# f32 (one sequence per data rank), four ranks against one process,
# within DIST_F32_TOL per leaf (relative L2: the f32 CPU-port tests hold
# 1e-5; on the card the reductions over four ranks' partial sums and the
# card's scatter order add ~1e-6).  DIST_TRAIN_MARGIN: the share of the
# card's memory kept free where a card's fit is worked out
DIST_TRAIN = dict(dims=(2, 2), seq=4096, accum=4, steps=2, check_layers=2,
                  depth=4)
DIST_TRAIN_MARGIN = 0.10
DIST_NORM_GRAD_TOL = 5e-3
DIST_NORM_LEAVES = ("['attn_norm']", "['mlp_norm']", "['final_norm']")
DIST_F32_TOL = 1e-4
# the reference's sharded GNN cells one card holds (launch/specs.py PERF:
# sharded_gnn=True on minibatch_lg, remat_group 4 for gatedgcn and
# graphcast) trained edge-parallel on make_host_mesh(data=4, model=1),
# four gloo ranks sharing the card, 2 f32 AdamW steps (3 before: a cut for
# the run's time); step 1 held to one process within TRAIN_FULL_TOL
GNN_DIST = dict(data=4, steps=2, cells=("gatedgcn", "graphcast", "gat-cora"))
# DCN-v2 at full size on make_host_mesh(data=2, model=2): the reference's
# _recsys_cell layout (no ZeRO: the four ranks' summed peak was predicted
# to fit the card), 2 steps (3 before: a cut for the run's time); the
# quantizer's key
RECSYS_DIST = dict(data=2, model=2, steps=2, zero=False, key=0)
# GPipe on make_host_mesh(pod=4, data=1, model=1): tanh(h @ W) stages at
# granite-8b's d_model, 8 microbatches of 2048 rows, f32 without TF32;
# against serial application (the same products) within tol
PIPELINE = dict(stages=4, d=4096, microbatches=8, rows=2048, reps=2,
                tol=1e-5)
# examples/motif_features_gnn.py's pipeline
MOTIF_GNN = dict(graph=dict(n_accounts=300, m=4_000, time_span=150_000,
                            n_rings=20, ring_size=5, n_smurf=16, seed=0),
                 motifs=("M5-3", "scatter-gather"), delta=2_500, K=1 << 13,
                 steps=60, acc_min=0.6)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


PHASE_SECONDS: dict = {}
# (arch, shape) -> seconds a call or step took on the card, filled by
# phases recsys_full, recsys_train and gnn_train for phase roofline
CARD_S: dict = {}


def timed(name: str, fn, *args, **kw):
    """``fn(*args, **kw)``, its wall time added to
    ``PHASE_SECONDS[name]``."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        PHASE_SECONDS[name] = (PHASE_SECONDS.get(name, 0.0)
                               + time.perf_counter() - t0)


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, name: str, reps: int = 20) -> float:
    """Mean device duration of the kernels whose name holds ``name`` over
    ``reps`` calls of ``fn``, from a device-only ``torch.profiler`` pass
    (the kernel's own time, without the host's gaps between calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):    # CUPTI now and then records none of a pass
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if name in e.key]
        us = sum(getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0) or 0
                 for e in hits)
        count = sum(e.count for e in hits)
        if count:
            return us / count / 1e3
    require(False, f"profiler: no '{name}' kernel in 3 passes of {reps} "
            "calls")


def host_us_per_call(fn, reps: int = 200) -> float:
    """Host time a call of ``fn`` takes to return, launches queued
    without a sync between calls (a wrapper slower than its kernel would
    set ``cuda_ms``)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def host_synced_s(fn, reps: int) -> float:
    """Mean host wall time of ``fn()`` with the device synced before and
    after each call (for work that launches many kernels and reads back
    on the host), after one warm-up call."""
    import torch
    fn()
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return total / reps


def bisect_steps(n):
    """Trips of a segment bisection over ``n`` elements (tensor):
    ``ceil(log2(n + 1))``, the loop runs while ``l < h``."""
    import torch
    return torch.ceil(torch.log2(n.double() + 1)).long()


def find_steps(n):
    """Trips of ``monotone_find`` over ``n`` positions (tensor):
    ``ceil(log2(n))``, the loop runs while ``h - l > 1``."""
    import torch
    return torch.ceil(torch.log2(n.clamp(min=1).double())).long()


def sampler_bytes(dev, wts, schedule, S, edges, window) -> int:
    """Bytes the tree sampler must move on this run's data.

    The key once and the outputs once (the kernel computes its draws:
    no draw inputs), plus one 8 B word per gather a bisection makes on
    each sample's own data: the window bisection over ``q``; the center
    edge's inverse CDF over its window's edge range; per child, the
    three bisections of the meet vertex's CSR segment and of its
    parallel-edge list (full segment lengths), then the inverse CDF over
    the delta range ``[plo, phi)`` only, each of its steps two prefix
    words plus, with the Claim 4.8 exclusion, the nested search over
    ``[qlo, qhi)`` and two more prefix words.
    """
    import torch
    from repro_torch.core.bisect import (bisect_iters, seg_lower_bound,
                                         seg_upper_bound)
    K = window.shape[0]
    t = dev["t"]
    it = bisect_iters(t.shape[0])
    delta, wd = wts.delta, wts.wd
    win = window
    words = bisect_steps(torch.full_like(win, wts.q)) + 4        # window
    span = wts.win_hi[win] - wts.win_lo[win]
    words = words + 2 + 2 * find_steps(span)                     # center
    for (s, c, meet_end, alpha, beta, use_rev) in schedule:
        e = edges[:, s]
        meet = (dev["src"] if meet_end == 0 else dev["dst"])[e].long()
        te = t[e]
        ptr, csr_t = ((dev["out_ptr"], dev["out_t"]) if alpha > 0
                      else (dev["in_ptr"], dev["in_t"]))
        p0, p1 = ptr[meet], ptr[meet + 1]
        if beta < 0:
            tlo, thi = torch.maximum(te - delta, win * wd), te
        else:
            tlo, thi = te, torch.minimum(te + delta, (win + 2) * wd - 1)
        plo = seg_lower_bound(csr_t, p0, p1, tlo, iters=it)
        phi = seg_upper_bound(csr_t, p0, p1, thi, iters=it)
        evals = find_steps(phi - plo) + 1      # g at each step and at phi
        words = words + 5 + 3 * bisect_steps(p1 - p0) + 2 + 2 * evals
        if wts.use_c2:
            pid = (dev["rev_pair_id"] if use_rev else dev["pair_id"])[e]
            pid = pid.long()
            pid0 = pid.clamp(min=0)
            q0 = dev["pair_ptr"][pid0]
            q1 = torch.where(pid >= 0, dev["pair_ptr"][pid0 + 1], q0)
            qlo = seg_lower_bound(dev["pair_t"], q0, q1, tlo, iters=it)
            qhi = seg_upper_bound(dev["pair_t"], q0, q1, thi, iters=it)
            words = (words + 3 + 3 * bisect_steps(q1 - q0) + 2
                     + evals * (bisect_steps(qhi - qlo) + 2))
    io = 16 + K * 8 * (S + 1)
    return int(words.sum()) * 8 + io


def device_profile(fn, kinds=None, top: int = 5) -> dict:
    """Wall clock of ``fn()`` under ``torch.profiler`` (ending in a
    device sync), the device-busy time summed over the device-side
    kernel entries, the idle share, and the top kernels by device time.
    ``kinds`` maps a label to a predicate on the kernel name; the busy
    time is also split by the first label whose predicate holds.  Only
    the device's activity is recorded: host op events (which nothing
    here reads) took ~100 s to gather after a step of ~100 k launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) or 0)
    # a kernel's time shows under the op that launched it and under the
    # kernel's own entry: count the device-side entries only
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) != DeviceType.CPU]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    out = {"profiled_wall_s": wall, "device_busy_s": busy,
           "device_idle_share": 1 - busy / wall if wall > 0 else None,
           "kernel_launches": sum(e.count for e in kernels),
           "top_kernels": [[e.key[:80], e.count, dev_us(e) / 1e3]
                           for e in sorted(kernels, key=dev_us,
                                           reverse=True)[:top]]}
    if kinds:
        split = dict.fromkeys([*kinds, "other"], 0.0)
        for e in kernels:
            kind = next((k for k, pred in kinds.items() if pred(e.key)),
                        "other")
            split[kind] += dev_us(e) / 1e6
        out["device_s_by_kind"] = split
    return out


def check_close(what: str, got, want, dtype: str, allow=0.0) -> dict:
    """Hold a kernel's output against its plain version (``KERNEL_TOL``,
    plus ``allow`` per element where the two may round p to either bf16
    neighbour: ``repro_torch.testing.p_rounding_allowance``); return the
    readings."""
    import torch
    tol = KERNEL_TOL[dtype]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rms = float(want.pow(2).mean().sqrt())
    limit = tol["atol_rel"] * rms + tol["rtol"] * want.abs()
    rec = dict(max_abs_err=float(err.max()), rel_l2=rel_l2(got, want),
               want_rms=rms, **tol)
    if not isinstance(allow, float):
        rec.update(p_flip_allowance_max=float(allow.max()),
                   over_limit_without_allowance=int((err > limit).sum()))
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    ok = bool((err <= limit + allow).all())
    require(ok and rec["rel_l2"] <= tol["rel_l2_max"],
            f"{what}: max |err| {rec['max_abs_err']}, relative L2 "
            f"{rec['rel_l2']} (limits {tol}, output rms {rms})")
    return rec


def check_fault(what: str, name: str, faulty, want, dtype: str) -> float:
    """How far a known fault moves the output (computed with the plain
    version); fails unless the check above could see it."""
    moved = rel_l2(faulty, want)
    limit = FAULT_FACTOR * KERNEL_TOL[dtype]["rel_l2_max"]
    require(moved >= limit, f"{what}: the check cannot see '{name}' "
            f"(relative L2 {moved} < {limit})")
    return moved


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(out, flush=True)
    emit({"phase": "card", "nvidia_smi": out})
    return out


def ptxas_label(entry: str) -> str:
    """A CUDA-core kernel instantiation's name from its mangled one."""
    import re
    m = re.search(r"flash_attention_kernelI(f|13__nv_bfloat16)Li(\d+)E",
                  entry)
    if m:
        return f"{'f32' if m.group(1) == 'f' else 'bf16'} D {m.group(2)}"
    m = re.search(r"sm_f32_kernelILb([01])E", entry)
    if m:
        return f"f32, {'16-byte' if m.group(1) == '1' else 'scalar'} loads"
    m = re.search(r"embedding_bag_(scalar_)?kernelI(f|13__nv_bfloat16)"
                  r"(f|S1_)([il])(?:Li(\d+)E)?", entry)
    if m:
        table = "f32" if m.group(2) == "f" else "bf16"
        out = "f32" if m.group(3) == "f" else table
        ids = f"int{32 if m.group(4) == 'i' else 64} ids"
        how = "one element a load" if m.group(1) else f"bpt {m.group(5)}"
        return f"{table} -> {out}, {ids}, {how}"
    return "bf16 mma.sync" if "sm_bf16_kernel" in entry else entry


def phase_build() -> dict:
    """Build every kernel; return the registers and spills ptxas reports
    for each instantiation of the two CUDA-core kernels and of the
    EmbeddingBag kernel."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build()
    usage = {name: {ptxas_label(e): u for e, u in
                    _build.ptxas_usage(_build.REPORTS.get(name, "")).items()}
             for name in ("flash_attention", "segment_matmul",
                          "embedding_bag")}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": built, "dir": str(_build.BUILD_DIR.relative_to(ROOT)),
          "ptxas": usage})
    return usage


def dep_sum_bytes(dev, d, use_c2: bool) -> int:
    """Bytes one dep-sum must move: each array the function needs read
    once (each edge's time and meet vertex, the alpha-CSR's pointers and
    times, the child's two prefixes; with C2 each edge's pair id, the
    pair pointers and times and two prefixes) and the output once: 72 m
    + 8 n + 8 P B with C2.  The kernel's own order (``perm`` and the
    gather back, ``pos``) is a cost of its design, not of the function,
    and is not counted."""
    from repro_torch.kernels.interval_weight.ref import pair_ids
    alpha = "out" if d.alpha > 0 else "in"
    need = [dev["t"], dev["src" if d.meet_end == 0 else "dst"],
            dev[f"{alpha}_ptr"], dev[f"{alpha}_t"]]
    if use_c2:
        need += [pair_ids(dev, d), dev["pair_ptr"], dev["pair_t"]]
    m = dev["t"].shape[0]
    prefixes = (4 if use_c2 else 2) * (m + 1) * 8
    return (sum(x.numel() * x.element_size() for x in need)
            + prefixes + m * 8)


def composite_dep_sum(dev, d, window, delta, wd, ps_csr, ps_pair, keys):
    """The library yardstick of one dep-sum: ``torch.searchsorted`` on
    composite keys ``owner * (time_span + 2) + t``, which are sorted
    globally in CSR order (``keys``: the alpha-CSR's and the pair-CSR's),
    three searches and the gathers per sum; several torch calls, not
    one."""
    import torch
    from repro_torch.kernels.interval_weight.ref import dep_sum_queries
    qs = dep_sum_queries(dev, d, delta, wd, window, ps_pair is not None)
    span = keys["span"]

    def iw(key, ps, q):
        owner, _, _, tlo, thi, brk = q
        base = owner * span
        plo = torch.searchsorted(key, base + tlo.clamp(min=0))
        phi = torch.searchsorted(key, base + thi.clamp(max=span - 1),
                                 right=True)
        pmid = torch.minimum(torch.maximum(torch.searchsorted(
            key, base + brk.clamp(max=span - 1)), plo), phi)
        return (ps[0][pmid] - ps[0][plo]) + (ps[1][phi] - ps[1][pmid])
    meet = (dev["src"] if d.meet_end == 0 else dev["dst"]).long()
    lam = iw(keys["out" if d.alpha > 0 else "in"], ps_csr,
             (meet, *qs["lam"][1:]))
    if ps_pair is None:
        return lam
    from repro_torch.kernels.interval_weight.ref import pair_ids
    pid = pair_ids(dev, d).long()
    el = iw(keys["pair"], ps_pair, (pid.clamp(min=0), *qs["el"][1:]))
    return lam - torch.where(pid >= 0, el, 0)


def composite_keys(dev) -> dict:
    import torch
    span = int(dev["t"][-1]) + 2

    def key(ptr, times):
        owner = torch.repeat_interleave(
            torch.arange(ptr.shape[0] - 1, device=ptr.device), ptr.diff())
        return owner * span + times
    return dict(span=span, out=key(dev["out_ptr"], dev["out_t"]),
                **{"in": key(dev["in_ptr"], dev["in_t"])},
                pair=key(dev["pair_ptr"], dev["pair_t"]))


def phase_interval_weight(dev, wts, tree) -> dict:
    """The dep-sum kernel against its plain version on every dep-sum of
    one real candidate tree (each dependency, own and prev, C2 on).  ``ms``
    times the wrapper: the kernel and its gather back to edge order,
    which ``gather_ms`` times alone."""
    import torch
    from repro_torch.kernels.interval_weight.ops import dep_sum, kernel_arrays
    from repro_torch.kernels.interval_weight.ref import dep_sum_ref
    keys = composite_keys(dev)
    m = dev["t"].shape[0]
    it = max(8, m.bit_length() + 1)
    runs, err = [], 0
    for s in tree.topo_down:
        for d in tree.deps[s]:
            c = d.child
            ps_csr = (wts.ps_acc_own[c], wts.ps_acc_prev[c])
            ps_pair = (wts.ps_pair_own[c], wts.ps_pair_prev[c])
            arrays = kernel_arrays(dev, d)   # once per kind on the path
            for window in ("own", "prev"):
                args = (dev, d, window, wts.delta, wts.wd, ps_csr, ps_pair)
                got = dep_sum(*args, arrays)
                want = dep_sum_ref(*args)
                lib = composite_dep_sum(*args, keys)
                torch.cuda.synchronize()
                require(got.dtype == want.dtype and torch.equal(got, want),
                        f"dep_sum kernel differs from its plain version "
                        f"(child {c}, {window})")
                require(torch.equal(lib, want), "composite-key yardstick "
                        "differs from the plain version")
                err = max(err, int((got - want).abs().max()))
                nbytes = dep_sum_bytes(dev, d, True)
                ops = m * 6 * it * 4
                runs.append(dict(
                    child=c, window=window, bytes=nbytes,
                    ms=cuda_ms(lambda: dep_sum(*args, arrays), reps=20),
                    gather_ms=cuda_ms(lambda: got[arrays["pos"]], reps=20),
                    library_ms=cuda_ms(
                        lambda: composite_dep_sum(*args, keys), reps=5),
                    bound_ms=max(nbytes / HBM_BYTES_PER_S,
                                 ops / OPS_PER_S) * 1e3,
                    bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                              >= ops / OPS_PER_S else "operations")))
    first = runs[0]
    d0 = tree.deps[tree.topo_down[0]][0]
    args0 = (dev, d0, "own", wts.delta, wts.wd,
             (wts.ps_acc_own[d0.child], wts.ps_acc_prev[d0.child]),
             (wts.ps_pair_own[d0.child], wts.ps_pair_prev[d0.child]))
    plain_ms = cuda_ms(lambda: dep_sum_ref(*args0), reps=2)

    def mean(k):
        return sum(r[k] for r in runs) / len(runs)
    rec = dict(name="interval_weight", route="cuda",
               source="src/repro_torch/kernels/interval_weight/csrc/"
                      "interval_weight.cu",
               replaces="src/repro/kernels/interval_weight/kernel.py:75",
               max_abs_err=err, ms=mean("ms"), plain_ms=plain_ms,
               bound_ms=mean("bound_ms"), bound_by=first["bound_by"],
               library_ms=mean("library_ms"))
    emit({"phase": "interval_weight", "m": m, "dep_sums": len(runs),
          "use_c2": True, "equal": True, "library_equal": True,
          "library": "torch.searchsorted on composite keys, 3 searches "
                     "and 4 gathers per sum: several calls, not one",
          "per_dep_sum": runs, "gather_ms": mean("gather_ms"),
          **{k: rec[k] for k in ("ms", "plain_ms", "bound_ms",
                                 "library_ms")}})
    return rec


def sampler_case(dev, wts, tree, chunk: int, key) -> tuple:
    """The keyed kernel against ``prepare_draws`` + the plain version on
    one chunk; returns the kernel's output and the largest absolute
    difference from the plain version's."""
    import torch
    from repro_torch.kernels.tree_sampler.ops import (build_schedule,
                                                      prepare_draws,
                                                      tree_sampler_keyed)
    from repro_torch.kernels.tree_sampler.ref import tree_sampler_ref
    args = (build_schedule(tree), tree.root, tree.num_edges, dev, wts)
    e_k, w_k = tree_sampler_keyed(*args, key, chunk)
    e_r, w_r = tree_sampler_ref(*args, *prepare_draws(tree, wts, key,
                                                       chunk))
    torch.cuda.synchronize()
    require(torch.equal(e_k, e_r) and torch.equal(w_k, w_r),
            f"tree_sampler kernel differs from prepare_draws + its plain "
            f"version (W = {int(wts.W_total)})")
    err = max(int((e_k - e_r).abs().max()), int((w_k - w_r).abs().max()))
    return e_k, w_k, err


def phase_tree_sampler(g, dev, wts, tree, chunk: int) -> dict:
    """The keyed kernel against its plain version on one full-size chunk,
    one chunk of the small graph (W < 2^32, where jax's randint reduction
    does not wrap) and one of the full graph at the first of
    ``WIDE_DELTAS`` whose W passes 2^32 (``mult`` wraps to 0); a second
    key must move the output.  One launch on the two keys stacked (a
    cohort's two seed streams) must equal the two solo launches, and is
    timed beside its bound."""
    import torch
    from repro_torch.core import rng
    from repro_torch.core.spanning_tree import candidate_trees
    from repro_torch.core.weights import preprocess
    from repro_torch.kernels.tree_sampler.ops import (build_schedule,
                                                      prepare_draws,
                                                      tree_sampler_keyed)
    from repro_torch.kernels.tree_sampler.ref import tree_sampler_ref
    from repro_torch.launch.estimate import parse_graph
    key = rng.fold_in(rng.PRNGKey(0), 0).cuda()
    key2 = rng.fold_in(rng.PRNGKey(1), 0).cuda()
    e_k, w_k, err = sampler_case(dev, wts, tree, chunk, key)
    e_2, w_2, err_2 = sampler_case(dev, wts, tree, chunk, key2)
    require(not torch.equal(e_k, e_2), "a second key left the sample "
            "unchanged")
    schedule = build_schedule(tree)
    S = tree.num_edges
    args = (schedule, tree.root, S, dev, wts)
    keys2 = torch.stack([key, key2])
    before = tree_sampler_keyed.launches
    e_j, w_j = tree_sampler_keyed(*args, keys2, chunk)
    torch.cuda.synchronize()
    require(tree_sampler_keyed.launches == before + 1,
            "two streams took more than one launch")
    require(torch.equal(e_j[0], e_k) and torch.equal(w_j[0], w_k)
            and torch.equal(e_j[1], e_2) and torch.equal(w_j[1], w_2),
            "a stream of the two-stream launch differs from its solo "
            "launch")
    sg = parse_graph(SMALL_GRAPH)
    stree = candidate_trees(tree.motif, n_candidates=3,
                            roots_per_tree=2)[0]
    sdev = sg.device_arrays("cuda")
    swts = preprocess(sg, stree, SMALL_CASES[0][1], dev=sdev)
    small_W = int(swts.W_total)
    require(0 < small_W < 2 ** 32, "small graph W not < 2^32")
    err_small = sampler_case(sdev, swts, stree, chunk, key)[2]
    del sdev, swts
    for wide_delta in WIDE_DELTAS:
        wide = preprocess(g, tree, wide_delta, dev=dev)
        wide_W = int(wide.W_total)
        if wide_W >= 2 ** 32:
            break
    require(wide_W >= 2 ** 32, f"no delta of {WIDE_DELTAS} gives W >= "
            f"2^32 (last W {wide_W})")
    err_wide = sampler_case(dev, wide, tree, chunk, key)[2]
    del wide
    torch.cuda.empty_cache()

    ms = cuda_ms(lambda: tree_sampler_keyed(*args, key, chunk), reps=20)
    ms_j2 = cuda_ms(lambda: tree_sampler_keyed(*args, keys2, chunk),
                    reps=20)
    bytes_j2 = (sampler_bytes(dev, wts, schedule, S, e_k, w_k)
                + sampler_bytes(dev, wts, schedule, S, e_2, w_2))
    bound_j2 = max(bytes_j2 / HBM_BYTES_PER_S,
                   bytes_j2 // 8 * 4 / OPS_PER_S) * 1e3
    plain_ms = cuda_ms(lambda: tree_sampler_ref(
        *args, *prepare_draws(tree, wts, key, chunk)), reps=2)
    draws_ms = cuda_ms(lambda: prepare_draws(tree, wts, key, chunk), reps=5)
    nbytes = sampler_bytes(dev, wts, schedule, S, e_k, w_k)
    ops = nbytes // 8 * 4
    bound = max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S) * 1e3
    rec = dict(name="tree_sampler", route="cuda",
               source="src/repro_torch/kernels/tree_sampler/csrc/"
                      "tree_sampler.cu",
               replaces="src/repro/kernels/tree_sampler/kernel.py:244",
               max_abs_err=max(err, err_2, err_small, err_wide), ms=ms,
               plain_ms=plain_ms,
               bound_ms=bound,
               bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops / OPS_PER_S else "operations"),
               library_ms=None, streams_2_ms=ms_j2,
               streams_2_bound_ms=bound_j2)
    emit({"phase": "tree_sampler", "K": chunk, "S": S, "bytes": nbytes,
          "W": int(wts.W_total), "W_gt_2^32": int(wts.W_total) > 2 ** 32,
          "small_W": small_W, "wide_delta": wide_delta, "wide_W": wide_W,
          "equal": True, "equal_small": True, "equal_wide": True,
          "second_key_moves": True, "prepare_draws_ms": draws_ms,
          "streams_2_equal_solo": True, "streams_2_bytes": bytes_j2,
          **{k: rec[k] for k in ("ms", "plain_ms", "bound_ms",
                                 "streams_2_ms", "streams_2_bound_ms")}})
    return rec


def phase_small() -> None:
    """Card against CPU (and the JAX reference's numbers) on a small graph."""
    from repro_torch import estimate, get_motif
    from repro_torch.launch.estimate import parse_graph
    g = parse_graph(SMALL_GRAPH)
    for name, delta, k, seed, (W, cnt2, valid) in SMALL_CASES:
        kw = dict(seed=seed, chunk=256)
        card = estimate(g, get_motif(name), delta, k, device="cuda", **kw)
        cpu = estimate(g, get_motif(name), delta, k, device="cpu", **kw)
        diff = [f for f in FIELDS if getattr(card, f) != getattr(cpu, f)]
        require(not diff, f"{name}: card != CPU in {diff}")
        got = (card.W, card.cnt2_sum, card.valid)
        require(got == (W, cnt2, valid),
                f"{name}: (W, cnt2, valid) = {got} != reference "
                f"{(W, cnt2, valid)}")
        emit({"phase": "small", "motif": name, "equal": True,
              **{f: getattr(card, f) for f in FIELDS}})


def dep_sums_of(motifs) -> int:
    """Dep-sums the planner runs to choose the trees of ``motifs`` at one
    delta: two per dependency of each distinct candidate tree signature
    (its Weights cache computes a signature once)."""
    from repro_torch import get_motif
    from repro_torch.core.spanning_tree import candidate_trees, tree_signature
    trees = {tree_signature(t): t for m in motifs
             for t in candidate_trees(get_motif(m), n_candidates=3,
                                      roots_per_tree=2)}
    return sum(2 * len(deps) for t in trees.values() for deps in t.deps)


def phase_full(g, motif_name: str, delta: int, k: int, chunk: int):
    """The main path at full size through the Session shim, launch
    counters read around it: one dep-sum launch per dep-sum of every
    candidate tree's DP, one sampler launch per chunk.  Returns the
    launches and the result."""
    import math

    import torch
    from repro_torch import estimate, get_motif
    from repro_torch.kernels.interval_weight.ops import dep_sum
    from repro_torch.kernels.tree_sampler.ops import tree_sampler_keyed
    want = dict(interval_weight=dep_sums_of([motif_name]),
                tree_sampler=-(-k // chunk))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dep_sum.launches = 0
    tree_sampler_keyed.launches = 0
    t0 = time.perf_counter()
    res = estimate(g, get_motif(motif_name), delta, k, seed=0, chunk=chunk,
                   device="cuda")
    wall = time.perf_counter() - t0
    launches = dict(interval_weight=dep_sum.launches,
                    tree_sampler=tree_sampler_keyed.launches)
    peak = torch.cuda.max_memory_allocated()
    require(0 < res.W < 2 ** 62, f"W_total {res.W} outside (0, 2^62)")
    require(math.isfinite(res.estimate) and res.estimate >= 0,
            f"estimate {res.estimate} not finite and non-negative")
    require(res.k == -(-k // chunk) * chunk, f"k {res.k} != k_eff")
    require(0 <= res.valid <= res.k and res.overflow <= res.k,
            "counts out of range")
    require(res.fail_vmap + res.fail_delta + res.fail_order + res.valid
            == res.k, "validation flags do not partition the samples")
    require(launches == want, f"kernel launches on the main path "
            f"{launches}, want one per dep-sum and per chunk: {want}")
    emit({"phase": "full", "motif": motif_name, "delta": delta,
          "m": g.m, "n": g.n, "estimate": res.estimate, "W": res.W,
          "W_lt_2^62": True, "k": res.k, "valid": res.valid,
          "cnt2_sum": res.cnt2_sum, "overflow": res.overflow,
          "fail_vmap": res.fail_vmap, "fail_delta": res.fail_delta,
          "fail_order": res.fail_order,
          "tree_edges": list(res.tree_edges), "wall_s": wall,
          "tree_select_s": res.tree_select_s,
          "preprocess_s": res.preprocess_s, "sampling_s": res.sampling_s,
          "samples_per_s": res.k / res.sampling_s,
          "sampler_backend": res.sampler_backend,
          "peak_mem_bytes": peak, "launches": launches})
    return launches, res


def same_result(a, b) -> bool:
    return all(getattr(a, f) == getattr(b, f) for f in FIELDS)


def plan_cohort(g, dev, delta: int) -> tuple:
    """The motifs of the service phase's tree cohort and how they were
    chosen: ``COHORT`` when the planner puts all of them on one shared
    Weights object (one tree signature) on this graph, else the largest
    group of registered motifs whose min-W trees share a signature (each
    motif planned with a planner of its own, freed before the next);
    then every group of two or more is named."""
    import torch
    from repro_torch import BatchPlanner, get_motif
    from repro_torch.core.motif import MOTIFS
    from repro_torch.core.spanning_tree import tree_signature
    planner = BatchPlanner(g, dev=dev)
    if len({id(planner.plan(get_motif(m), delta)[1]) for m in COHORT}) == 1:
        return COHORT, "the planned cohort"
    del planner
    torch.cuda.empty_cache()
    groups: dict = {}
    for name in MOTIFS:
        tree, _ = BatchPlanner(g, dev=dev).plan(get_motif(name), delta)
        groups.setdefault(tree_signature(tree), []).append(name)
        torch.cuda.empty_cache()
    best = max(groups.values(), key=len)
    require(len(best) > 1, "no two registered motifs share a tree "
            f"signature at delta {delta}")
    shared = sorted("/".join(v) for v in groups.values() if len(v) > 1)
    return tuple(best), (f"{'/'.join(COHORT)} do not share one signature "
                         "here: the largest group the planner forms (groups "
                         f"{', '.join(shared)})")


def phase_service(g, delta: int, k: int, chunk: int, full) -> dict:
    """The estimation service at full size, launch counters set to 0
    before its cohort and read after it.

    * cohort: ``COHORT`` x ``COHORT_SEEDS`` through one
      ``Session.submit_many``: one cohort of len(COHORT) lanes x 2
      streams, the sampler launched once per chunk for both streams,
      each cell equal to a solo ``estimate()`` (cell (M5-3, 0) to phase
      ``full``); then, on the cohort's own tree and Weights, one chunk
      timed by stage: the two-stream sampler and each lane's validation;
    * checkpoint: written at k / 2, resumed to k, equal to the unbroken
      run;
    * serve: three NDJSON requests through ``serve_loop`` (one adaptive,
      ``target_rse``), each ``ok`` with ``estimate()``'s integers.
    """
    import io

    import torch
    from repro_torch import EstimateConfig, Request, Session, estimate
    from repro_torch import get_motif
    from repro_torch.api import serve_loop
    from repro_torch.core import rng
    from repro_torch.core.engine import STATS
    from repro_torch.core.sampler import (make_batched_sample_fn,
                                          make_cohort_count_fn)
    from repro_torch.kernels.interval_weight.ops import dep_sum
    from repro_torch.kernels.tree_sampler.ops import tree_sampler_keyed
    dev = g.device_arrays("cuda")
    motifs, chosen = plan_cohort(g, dev, delta)
    del dev
    torch.cuda.empty_cache()
    n_chunks = -(-k // chunk)
    cells = [(m, s) for m in motifs for s in COHORT_SEEDS]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    STATS.reset()
    dep_sum.launches = 0
    tree_sampler_keyed.launches = 0
    t0 = time.perf_counter()
    session = Session(g, EstimateConfig(chunk=chunk))
    handles = session.submit_many([Request(m, delta, k, seed=s)
                                   for m, s in cells])
    results = [h.result() for h in handles]
    wall = time.perf_counter() - t0
    launches = dict(interval_weight=dep_sum.launches,
                    tree_sampler=tree_sampler_keyed.launches)
    peak = torch.cuda.max_memory_allocated()
    stats = {f: getattr(STATS, f) for f in (
        "dispatches", "fused_dispatches", "job_windows", "tree_cohorts",
        "cohort_motif_lanes", "samples_shared", "witness_dispatches")}
    windows = -(-n_chunks // session.config.checkpoint_every)
    require(all(r.fused_jobs == len(cells) for r in results),
            f"the {len(cells)} jobs did not form one cohort: fused_jobs "
            f"{[r.fused_jobs for r in results]}")
    require(stats["tree_cohorts"] == windows
            and stats["cohort_motif_lanes"] == windows * len(motifs),
            f"not one cohort of {len(motifs)} lanes a window: {stats}")
    want = dict(interval_weight=dep_sums_of(motifs), tree_sampler=n_chunks)
    require(launches == want, f"cohort launches {launches}, want one "
            f"sampler launch per chunk for all {len(COHORT_SEEDS)} streams "
            f"and one dep-sum launch per dep-sum: {want}")

    solo_wall, solos, equal_full = 0.0, [], None
    for (m, s), res in zip(cells, results):
        t0 = time.perf_counter()
        solo = estimate(g, get_motif(m), delta, k, seed=s, chunk=chunk)
        solo_wall += time.perf_counter() - t0
        solos.append(solo)
        require(same_result(res, solo), f"cohort cell ({m}, {s}) differs "
                f"from its solo estimate")
        if (m, s) == (full.motif, 0):
            equal_full = same_result(res, full)
            require(equal_full, f"cohort cell ({m}, 0) differs from phase "
                    "full")

    # one chunk by stage on the cohort's tree and shared Weights
    lead = handles[0]._tree
    trees = tuple(dict.fromkeys(h._tree for h in handles))
    wts, dev = handles[0]._wts, session.dev
    keys = rng.fold_in(torch.stack([rng.PRNGKey(s) for s in COHORT_SEEDS]),
                       0).cuda()
    bs_fn = make_batched_sample_fn(lead, chunk, "cuda")
    samples = bs_fn(dev, wts, keys)
    sample_ms = cuda_ms(lambda: bs_fn(dev, wts, keys), reps=10)
    lane_ms = {}
    for tree in trees:
        cc = make_cohort_count_fn((tree,), chunk)
        lane_ms[tree.motif.name] = 1e3 * host_synced_s(
            lambda: cc(dev, wts, samples), reps=5)
    del session, handles, samples, wts, dev
    torch.cuda.empty_cache()

    # checkpoint: k / 2, then resumed to k
    path = ROOT / "build" / "service_checkpoint.json"
    path.parent.mkdir(exist_ok=True)
    path.unlink(missing_ok=True)
    motif = get_motif(full.motif)
    half = estimate(g, motif, delta, k // 2, seed=0, chunk=chunk,
                    checkpoint_path=str(path))
    done_half = json.loads(path.read_text())["chunks_done"]
    t0 = time.perf_counter()
    resumed = estimate(g, motif, delta, k, seed=0, chunk=chunk,
                       checkpoint_path=str(path))
    resume_wall = time.perf_counter() - t0
    done = json.loads(path.read_text())["chunks_done"]
    path.unlink()
    require(done_half == n_chunks // 2 and done == n_chunks,
            f"checkpoint chunks_done {done_half}, {done}")
    require(same_result(resumed, full), "the resumed run differs from the "
            "unbroken one")

    # serve: three NDJSON requests over in-memory streams
    lines = [dict(id=1, motif=full.motif, delta=delta, k=k, seed=0),
             dict(id=2, motif=cells[1][0], delta=delta, k=k,
                  seed=cells[1][1]),
             dict(id=3, motif=full.motif, delta=delta, k=k // 4, seed=1,
                  target_rse=0.2, k_max=k)]
    out = io.StringIO()
    session = Session(g, EstimateConfig(chunk=chunk,
                                        coalesce_window_s=3600.0))
    t0 = time.perf_counter()
    served = serve_loop(session, infile=io.StringIO(
        "".join(json.dumps(ln) + "\n" for ln in lines)), outfile=out)
    serve_wall = time.perf_counter() - t0
    answers = [json.loads(ln) for ln in out.getvalue().splitlines()]
    require(served == 3 and len(answers) == 3
            and all(a["ok"] for a in answers), f"serve answers {answers}")
    del session
    torch.cuda.empty_cache()
    for line, ans in zip(lines, answers):
        want = estimate(g, get_motif(line["motif"]), delta, ans["k"],
                        seed=line["seed"], chunk=chunk)
        got = (ans["id"], ans["estimate"], ans["W"], ans["k"], ans["valid"],
               ans["sampler_backend"])
        require(got == (line["id"], want.estimate, want.W, want.k,
                        want.valid, "cuda"),
                f"serve answer {ans} differs from estimate() {want}")
    emit({"phase": "service", "motifs": list(motifs), "chosen": chosen,
          "seeds": list(COHORT_SEEDS), "delta": delta, "k": k,
          "chunk": chunk, "lanes": len(trees),
          "streams": len(COHORT_SEEDS), "cells_equal_solo": True,
          "cell_equal_full": equal_full, "cohort_wall_s": wall,
          "cohort_samples_per_s": len(COHORT_SEEDS) * n_chunks * chunk
          / results[0].sampling_s,
          "cohort_sampling_s": results[0].sampling_s,
          "cohort_tree_select_s": sum(r.tree_select_s for r in results),
          "solo_wall_s": solo_wall,
          "solo_sampling_s": sum(r.sampling_s for r in solos),
          "launches": launches, "sampler_launches_per_cohort_chunk":
              launches["tree_sampler"] / n_chunks,
          "engine_stats": stats, "peak_mem_bytes": peak,
          "chunk_sample_2_streams_ms": sample_ms,
          "chunk_validation_ms_per_lane": lane_ms,
          "results": [[m, s, r.W, r.cnt2_sum, r.valid, r.estimate]
                      for (m, s), r in zip(cells, results)],
          "checkpoint_equal_unbroken": True, "half_k": half.k,
          "resume_wall_s": resume_wall, "serve_equal_estimate": True,
          "serve_wall_s": serve_wall,
          "serve_answers": [{k_: a[k_] for k_ in (
              "id", "k", "W", "valid", "estimate", "rse", "fused_jobs",
              "windows")} for a in answers]})
    return launches, dict(motifs=motifs, cells=cells, results=results)


def phase_oracle(chunk: int, k: int) -> None:
    """The estimate against the exact count on a mid-size graph: its
    relative error is printed, not gated."""
    from repro_torch import count_exact, estimate, get_motif
    from repro_torch.launch.estimate import parse_graph
    g = parse_graph(ORACLE_GRAPH)
    for name, delta in ORACLE_CASES:
        t0 = time.perf_counter()
        exact = count_exact(g, get_motif(name), delta)
        exact_s = time.perf_counter() - t0
        res = estimate(g, get_motif(name), delta, k, chunk=chunk)
        emit({"phase": "oracle", "graph": ORACLE_GRAPH, "n": g.n, "m": g.m,
              "motif": name, "delta": delta, "k": res.k, "exact": exact,
              "estimate": res.estimate, "rel_err":
                  abs(res.estimate - exact) / max(exact, 1),
              "valid": res.valid, "W": res.W, "exact_s": exact_s,
              "estimate_s": res.tree_select_s + res.sampling_s})


def stream_rows(er) -> list:
    """An epoch's comparable record: the epoch's numbers and each
    standing query's integer fields and witness tuples."""
    ep = er.epoch
    return [(ep.index, ep.m_real, ep.n_real, ep.evicted, ep.buckets)] + [
        (qid, *(getattr(r, f) for f in FIELDS), r.witnesses)
        for qid, r in sorted(er.results.items())]


def phase_stream_small() -> None:
    """Card against CPU on a small live stream: ``SMALL_GRAPH``'s edges
    in 4 batches, horizon 20000, M5-3 and M4-2 (with witnesses) standing;
    every epoch's integers and witness tuples equal."""
    import numpy as np
    from repro_torch import EstimateConfig
    from repro_torch.launch.estimate import parse_graph
    from repro_torch.stream import StandingQuery, StreamingSession
    t_phase = time.perf_counter()
    g = parse_graph(SMALL_GRAPH)
    runs = {}
    for device in ("cuda", "cpu"):
        ss = StreamingSession(config=EstimateConfig(chunk=256, device=device),
                              horizon=20000)
        for m, d, k, seed, wit in STREAM_SMALL:
            ss.subscribe(StandingQuery(m, d, k, seed=seed, witnesses=wit))
        rows = []
        for idx in np.array_split(np.arange(g.m), 4):
            ss.ingest(g.src[idx], g.dst[idx], g.t[idx])
            rows.append(stream_rows(ss.advance()))
        ss.close()
        runs[device] = rows
    require(runs["cuda"] == runs["cpu"], "stream_small: card != CPU")
    wit = [r[2][-1] for r in runs["cuda"]]
    require(all(wit), "stream_small: an epoch without witnesses")
    emit({"phase": "stream_small", "equal": True, "epochs": [
        {"m_real": r[0][1], "buckets": list(r[0][4]), "evicted": r[0][3],
         "cnt2_sum": [q[4] for q in r[1:]], "witnesses": len(r[2][-1])}
        for r in runs["cuda"]], "phase_s": time.perf_counter() - t_phase})


def padded_kernel_checks(graph, queries, chunk: int) -> dict:
    """Both TIMEST kernels against their plain versions on one padded
    epoch snapshot, at the shapes the stream path gives them: every
    dep-sum of every candidate tree the standing queries' planner
    computes, and one chunk of each tree through ``sampler_case``, whose
    edges must all be real (``< m_real``) and whose windows must lie in
    the real ``[0, q)``.  Returns the check counts and each kernel's
    largest difference."""
    import torch
    from repro_torch import get_motif
    from repro_torch.core import rng
    from repro_torch.core.spanning_tree import candidate_trees, tree_signature
    from repro_torch.core.weights import preprocess
    from repro_torch.kernels.interval_weight.ops import dep_sum, kernel_arrays
    from repro_torch.kernels.interval_weight.ref import dep_sum_ref
    dev = graph.device_arrays("cuda")
    m_real = graph.live_m
    trees = {}
    for q in queries:
        for t in candidate_trees(get_motif(q.motif), n_candidates=3,
                                 roots_per_tree=2):
            trees.setdefault((tree_signature(t), q.delta), t)
    out = dict(m=graph.m, m_real=m_real, trees=len(trees), dep_sums=0,
               sampler_chunks=0, dep_sum_err=0, sampler_err=0)
    for (_, delta), tree in trees.items():
        wts = preprocess(graph, tree, delta, dev=dev)
        require(wts.q_pad >= wts.q, "window arrays shorter than q")
        for s in tree.topo_down:
            for d in tree.deps[s]:
                c = d.child
                ps_csr = (wts.ps_acc_own[c], wts.ps_acc_prev[c])
                ps_pair = (wts.ps_pair_own[c], wts.ps_pair_prev[c])
                arrays = kernel_arrays(dev, d)
                for window in ("own", "prev"):
                    args = (dev, d, window, wts.delta, wts.wd, ps_csr,
                            ps_pair)
                    got = dep_sum(*args, arrays)
                    want = dep_sum_ref(*args)
                    torch.cuda.synchronize()
                    require(torch.equal(got, want), f"dep_sum kernel "
                            f"differs from its plain version on a padded "
                            f"snapshot (m {graph.m}, child {c}, {window})")
                    out["dep_sums"] += 1
                    out["dep_sum_err"] = max(out["dep_sum_err"], int(
                        (got - want).abs().max()))
        key = rng.fold_in(rng.PRNGKey(0), 0).cuda()
        e_k, w_k, err = sampler_case(dev, wts, tree, chunk, key)
        require(int(e_k.max()) < m_real and int(w_k.max()) < wts.q,
                f"the sampler drew a pad edge or window on a padded "
                f"snapshot (m {graph.m}, m_real {m_real}, q {wts.q})")
        out["sampler_chunks"] += 1
        out["sampler_err"] = max(out["sampler_err"], err)
        del wts
    del dev
    torch.cuda.empty_cache()
    return out


def unpadded(g):
    """A padded snapshot's real edges, rebuilt: the retained graph as the
    store built it before padding."""
    from repro_torch import TemporalGraph
    m = g.live_m
    return TemporalGraph.from_edges(g.src[:m], g.dst[:m], g.t[:m])


def phase_stream(g, chunk: int, k: int) -> dict:
    """The live stream at full size: ``g``'s edges written as ``.npz``,
    replayed by ``replay_epochs`` in ``STREAM_BATCHES`` batches (one
    epoch each) with horizon ``time_span // 4`` and a WAL, M5-3 and M4-2
    (8 witnesses) standing.  Launch counters are set to 0 before the
    replay and read after it.  Requires (a) epochs 0 and 7 equal to a
    cold ``estimate()`` on the padded snapshot, epoch 7 also on the
    unpadded one; (b) every witness a real edge tuple satisfying its
    motif; (c) a store recovered from the WAL copied after epoch
    ``STREAM_RECOVER_AT``, fed the next batch, equal to the live store's
    next snapshot and M5-3 estimate; (d) both kernels launched, the
    sampler once per cohort chunk plus once per witness re-draw; (e) the
    card's allocated memory back within 64 MB after ``close()``; (f) on
    the snapshots of epochs 0 and 7 (m buckets 2^20 and 2^21), both
    kernels equal to their plain versions (``padded_kernel_checks``).
    Returns the launches and each kernel's largest difference there."""
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch import EstimateConfig, estimate, get_motif
    from repro_torch.core.engine import STATS
    from repro_torch.kernels.interval_weight.ops import dep_sum
    from repro_torch.kernels.tree_sampler.ops import tree_sampler_keyed
    from repro_torch.stream import (StandingQuery, StreamingSession,
                                    StreamStore, replay_epochs)
    from repro_torch.testing import witness_edge_ids
    t_phase = time.perf_counter()
    k = min(STREAM_K, k)
    horizon = g.time_span // 4
    batch = -(-g.m // STREAM_BATCHES)
    n_chunks = -(-k // chunk)
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as tmp:
        edges, wal = f"{tmp}/edges.npz", f"{tmp}/stream.wal"
        np.savez(edges, src=g.src, dst=g.dst, t=g.t)
        ss = StreamingSession(StreamStore(horizon=horizon, wal=wal),
                              EstimateConfig(chunk=chunk, device="cuda"))
        queries = [StandingQuery(m, d, k, seed=s, witnesses=w)
                   for m, d, s, w in STREAM_QUERIES]
        for q in queries:
            ss.subscribe(q)
        kept, epochs = {}, []
        reset_counters(dep_sum, tree_sampler_keyed)
        STATS.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        wit_s = 0.0
        for er in replay_epochs(ss, edges, batch_size=batch):
            ep = er.epoch
            peak = torch.cuda.max_memory_allocated()
            drawn = sum(r.k for r in er.results.values())
            # the witness windows' share of estimate_s (engine timer)
            wit_s, ep_wit_s = STATS.witness_s, STATS.witness_s - wit_s
            epochs.append({
                "epoch": ep.index, "m_real": ep.m_real,
                "buckets": list(ep.buckets), "evicted": ep.evicted,
                "snapshot_s": ep.snapshot_s, "advance_s": er.advance_s,
                "estimate_s": er.estimate_s, "witness_s": ep_wit_s,
                "witness_share": ep_wit_s / er.estimate_s,
                "samples_per_s": drawn / er.estimate_s,
                "peak_mem_bytes": peak,
                "cnt2_sum": [r.cnt2_sum for _, r in sorted(
                    er.results.items())]})
            for qid, q in enumerate(queries):          # (b), on the host
                res = er.results[qid]
                require(res.W > 0 and res.k == n_chunks * chunk,
                        f"stream epoch {ep.index}: {q.label} W {res.W}, "
                        f"k {res.k}")
                require(len(res.witnesses or ()) == q.witnesses,
                        f"stream epoch {ep.index}: {q.label} has "
                        f"{len(res.witnesses or ())} witnesses")
                for entry in res.witnesses or ():
                    witness_edge_ids(ep.graph, get_motif(q.motif),
                                     res.tree_edges, q.delta, entry)
            if ep.index in (0, STREAM_RECOVER_AT + 1, STREAM_BATCHES - 1):
                kept[ep.index] = er
            if ep.index == STREAM_RECOVER_AT:
                shutil.copy(wal, f"{tmp}/recover.wal")
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t0
        launches = dict(interval_weight=dep_sum.launches,
                        tree_sampler=tree_sampler_keyed.launches)
        redraws = STATS.witness_chunks
        stats = {f: getattr(STATS, f) for f in (
            "dispatches", "tree_cohorts", "witness_dispatches",
            "witness_chunks", "witness_s")}
        wal_records = ss.store.wal.records
        ss.close()
        ss.store.wal.close()
        del ss
        gc.collect()
        torch.cuda.synchronize()
        mem_closed = torch.cuda.memory_allocated()

        # (d) one sampler launch per cohort chunk, one per witness re-draw
        require(len(epochs) == STREAM_BATCHES, f"{len(epochs)} epochs")
        cohorts = (1 if kept[0].results[0].fused_jobs == len(queries)
                   else len(queries))
        want = dict(interval_weight=STREAM_BATCHES * dep_sums_of(
                        [q.motif for q in queries]),
                    tree_sampler=STREAM_BATCHES * (cohorts + 1) * n_chunks)
        require(launches == want
                and redraws == STREAM_BATCHES * n_chunks,
                f"stream launches {launches}, witness re-draws {redraws}; "
                f"want {want}, one dep-sum launch per dep-sum and one "
                "sampler launch per cohort chunk and per re-drawn chunk")
        # (e)
        require(abs(mem_closed - mem0) <= 64 << 20, f"allocated "
                f"{mem_closed} bytes after close(), {mem0} before")

        # (a) cold estimates on the padded and the unpadded snapshots
        cold = []
        for idx in (0, STREAM_BATCHES - 1):
            er = kept[idx]
            graphs = [er.epoch.graph] + (
                [unpadded(er.epoch.graph)] if idx else [])
            for graph in graphs:
                for qid, q in enumerate(queries):
                    res = estimate(graph, get_motif(q.motif), q.delta, k,
                                   seed=q.seed, chunk=chunk, device="cuda")
                    require(same_result(res, er.results[qid]),
                            f"stream epoch {idx}: {q.label} differs from "
                            f"a cold estimate on the "
                            f"{'padded' if graph.m_real else 'unpadded'} "
                            "snapshot")
                    cold.append([idx, q.label, graph.m, res.cnt2_sum])
            gc.collect()
            torch.cuda.empty_cache()

        # (f) both kernels against their plain versions on the kept
        # epochs' padded snapshots, at the 2^20 and 2^21 buckets
        padded = {idx: padded_kernel_checks(kept[idx].epoch.graph, queries,
                                            chunk)
                  for idx in (0, STREAM_BATCHES - 1)}

        # (c) recovery from the WAL copied after STREAM_RECOVER_AT
        t0 = time.perf_counter()
        rec = StreamStore.recover(f"{tmp}/recover.wal", horizon=horizon)
        recover_s = time.perf_counter() - t0
        nxt = STREAM_RECOVER_AT + 1
        z = np.load(edges)
        sl = slice(nxt * batch, (nxt + 1) * batch)
        rec.ingest(z["src"][sl], z["dst"][sl], z["t"][sl])
        ep = rec.advance()
        rec.wal.close()
        live = kept[nxt]
        require(ep.index == nxt and same_graph(ep.graph, live.epoch.graph),
                f"the recovered store's snapshot {ep.index} differs from "
                "the live store's")
        m53 = queries[0]
        res = estimate(ep.graph, get_motif(m53.motif), m53.delta, k,
                       seed=m53.seed, chunk=chunk, device="cuda")
        require(same_result(res, live.results[0]), "the recovered store's "
                "M5-3 estimate differs from the live store's")
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "stream", "graph_m": g.m, "batch": batch,
          "horizon": horizon, "k": k, "chunk": chunk,
          "queries": [list(q) for q in STREAM_QUERIES],
          "epochs": epochs, "stream_s": stream_s,
          "witness_share": stats["witness_s"] / sum(
              e["estimate_s"] for e in epochs),
          "launches": launches, "witness_redraws": redraws,
          "engine_stats": stats, "wal_records": wal_records,
          "cold_equal": cold, "recovered_equal_live": True,
          "padded_kernels": padded,
          "recover_s": recover_s, "mem_before": mem0,
          "mem_after_close": mem_closed,
          "phase_s": time.perf_counter() - t_phase})
    return launches, dict(
        interval_weight=max(p["dep_sum_err"] for p in padded.values()),
        tree_sampler=max(p["sampler_err"] for p in padded.values()))


class GatewayWire:
    """``gateway_serve_loop`` on a thread of this process, fed through a
    pipe: ``send`` writes one request line, ``wait`` blocks until an
    answer line matches, so the phase can order its steps (install a
    fault schedule, read a counter) between answers."""

    def __init__(self, config, **loop_kw):
        import os
        import queue
        import threading

        from repro_torch.gateway import gateway_serve_loop
        r, w = os.pipe()
        self._rf = os.fdopen(r, "r")
        self._wf = os.fdopen(w, "w", buffering=1)
        self._q: queue.Queue = queue.Queue()
        self.lines: list = []
        self.served = None
        self.error = None

        wire = self

        class _Out:
            def write(self, text):
                for ln in text.splitlines():
                    wire._q.put(json.loads(ln))

            def flush(self):
                pass

        def run():
            try:
                self.served = gateway_serve_loop(config, infile=self._rf,
                                                 outfile=_Out(), **loop_kw)
            except BaseException as e:      # reported by wait()
                self.error = e
            finally:
                self._q.put(None)           # the loop's output ended

        self._thread = threading.Thread(target=run, name="smoke-gateway")
        self._thread.start()

    def send(self, obj: dict) -> None:
        self._wf.write(json.dumps(obj) + "\n")

    def wait(self, pred, timeout: float = 300.0) -> dict:
        import queue
        deadline = time.perf_counter() + timeout
        while True:
            left = deadline - time.perf_counter()
            require(left > 0, "gateway: no answer matched in time")
            try:
                ln = self._q.get(timeout=left)
            except queue.Empty:
                continue
            require(ln is not None, f"gateway: the loop ended "
                    f"({self.error!r}) before the answer")
            self.lines.append(ln)
            if pred(ln):
                return ln

    def ask(self, obj: dict, pred=None) -> dict:
        """Send ``obj`` and wait for its answer (by id, else by cmd)."""
        self.send(obj)
        if pred is None:
            if "id" in obj:
                def pred(ln):
                    return ln.get("id") == obj["id"] and not ln.get(
                        "progress")
            else:
                def pred(ln):
                    return ln.get("cmd") == obj["cmd"]
        return self.wait(pred)

    def close(self) -> int:
        self.ask({"cmd": "quit"})
        self._wf.close()
        self._thread.join(600)
        require(not self._thread.is_alive(), "gateway: loop did not stop")
        self._rf.close()
        return self.served


class Uncounted:
    """Launches inside the block (comparisons with direct runs) do not
    count toward the gateway path's launches."""

    def __init__(self, *fns):
        self.fns = fns

    def __enter__(self):
        self.saved = [fn.launches for fn in self.fns]

    def __exit__(self, *exc):
        for fn, n in zip(self.fns, self.saved):
            fn.launches = n
        return False


def keyed_answers(lines) -> dict:
    """Gateway answers keyed by (tenant, id, progress window) or (tenant,
    sub, epoch) or (tenant, cmd, n-th), without the fields that differ
    between devices or runs (``sampler_backend``, ``advance_s``)."""
    out, seen = {}, {}
    for ln in lines:
        if ln.get("cmd") in ("health", "stats"):
            continue
        got = {k: v for k, v in ln.items()
               if k not in ("sampler_backend", "advance_s")}
        if "id" in ln:
            key = ("id", ln.get("tenant"), ln["id"],
                   ln.get("window") if ln.get("progress") else None)
        elif "sub" in ln and "epoch" in ln:
            key = ("sub", ln.get("tenant"), ln["sub"], ln["epoch"])
        else:
            base = (ln.get("tenant"), ln.get("cmd"), ln.get("error"))
            seen[base] = seen.get(base, 0) + 1
            key = ("line", *base, seen[base])
        out[key] = got
    return out


def gateway_small_script() -> list:
    """(f)'s wire script on ``SMALL_GRAPH``: a graph tenant with two
    requests (one with witnesses), a stream tenant fed in two batches."""
    from repro_torch.launch.estimate import parse_graph
    g = parse_graph(SMALL_GRAPH)
    edges = [[int(a), int(b), int(c)] for a, b, c in zip(g.src, g.dst, g.t)]
    half = len(edges) // 2
    return [
        {"cmd": "open_tenant", "tenant": "small", "graph": SMALL_GRAPH},
        {"cmd": "open_tenant", "tenant": "live", "stream": True},
        {"tenant": "small", "id": 1, "motif": "M5-3", "delta": 3000,
         "k": 1024, "witnesses": 2},
        {"tenant": "small", "id": 2, "motif": "M4-2", "delta": 3000,
         "k": 512, "seed": 3},
        {"cmd": "subscribe", "tenant": "live", "motif": "M4-2",
         "delta": 3000, "k": 512, "witnesses": 2},
        {"cmd": "ingest", "tenant": "live", "edges": edges[:half]},
        {"cmd": "advance", "tenant": "live"},
        {"cmd": "ingest", "tenant": "live", "edges": edges[half:]},
        {"cmd": "advance", "tenant": "live"},
        {"cmd": "quit"}]


def wire_witnesses(res) -> list:
    return [dict(edges=[list(e) for e in w["edges"]], cnt=w["cnt"])
            for w in res.witnesses]


def phase_gateway(g, graph_spec: str, delta: int, k: int, chunk: int,
                  full) -> dict:
    """The multi-tenant gateway on the card: ``gateway_serve_loop`` in
    this process on ``cuda`` with obs at ``trace``, a ``profile_dir`` and
    a ``wal_dir`` (both temporary, under ``build/``).  The launch
    counters are set to 0 before the wire session and read after it
    (direct runs it is compared with do not count).  Requires:

    (a) a graph tenant on the full graph answers M5-3 at ``delta``, k,
        seed 0 with phase ``full``'s integers, and M4-2 with 8 witnesses
        the entries of a direct Session request;
    (b) a stream tenant (WAL on, M4-2 with 4 witnesses standing) fed two
        batches of 65,536 of the graph's edges in time order answers
        each epoch as a direct ``StreamingSession``; closed and
        reopened, it recovers its store (epoch, buffer) and answers the
        next epoch as the live session does;
    (c) M5-3 again under three injected ``engine.dispatch`` faults:
        3 retries, one ladder step (the window halved), the integers of
        (a); a real ``torch.cuda.OutOfMemoryError`` classifies as
        ``retryable``;
    (d) a profile armed over the wire around two one-chunk requests
        writes a Chrome trace with a tree-sampler kernel event, and no
        profiler error; (a)'s spans
        chain intake -> queue wait -> drain -> dispatch -> emit under
        one trace id; ``metrics`` holds the retries and the stage
        histograms;
    (e) the same M5-3 estimate timed at ``off`` and at ``trace`` in
        paired runs (a reading);
    (f) one wire script on ``SMALL_GRAPH`` through a ``cpu`` and a
        ``cuda`` gateway: equal answers, timing fields aside.
    """
    import io
    import os
    import tempfile

    import numpy as np
    import torch
    from repro_torch import EstimateConfig, Request, Session, estimate, obs
    from repro_torch import get_motif
    from repro_torch.core.engine import STATS
    from repro_torch.gateway import gateway_serve_loop
    from repro_torch.kernels.interval_weight.ops import dep_sum
    from repro_torch.kernels.tree_sampler.ops import tree_sampler_keyed
    from repro_torch.resilience import STATS as RSTATS
    from repro_torch.resilience import FaultInjector, FaultSpec, classify
    from repro_torch.stream import StandingQuery, StreamingSession
    t_phase = time.perf_counter()
    kernels = (dep_sum, tree_sampler_keyed)
    k_wit = min(STREAM_K, k)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=ROOT / "build",
                                      prefix="gateway_")
    prof_dir, wal_dir = f"{tmp.name}/profile", f"{tmp.name}/wal"
    obs.set_level("trace")
    obs.set_ring(1 << 16)           # the whole session's spans stay
    obs.RECORDER.clear()
    STATS.reset()
    RSTATS.reset()
    reset_counters(*kernels)
    cfg = EstimateConfig(chunk=chunk)
    wire = GatewayWire(cfg, max_tenants=4, wal_dir=wal_dir,
                       profile_dir=prof_dir)
    walls = {}

    # (a) a graph tenant at full width; a profile of two one-chunk
    # requests' windows first (a window of 64 chunks would hold ~60,000
    # kernels and their torch ops)
    t0 = time.perf_counter()
    opened = wire.ask({"cmd": "open_tenant", "tenant": "wiki",
                       "graph": graph_spec})
    walls["open_tenant"] = time.perf_counter() - t0
    require(opened.get("ok"), f"gateway: open_tenant {opened}")
    m53 = {"tenant": "wiki", "motif": full.motif, "delta": delta, "k": k,
           "seed": 0}
    prof = wire.ask({"cmd": "profile", "windows": 2})
    require(prof.get("ok"), f"gateway: profile {prof}")
    for rid, seed in ((10, 0), (11, 1)):
        one = wire.ask({**m53, "id": rid, "k": chunk, "seed": seed})
        require(one.get("ok") and one["windows"] == 1,
                f"gateway (d): profiled request {one}")
    t0 = time.perf_counter()
    a = wire.ask({"id": 1, **m53})
    walls["m53"] = time.perf_counter() - t0
    got = (a.get("estimate"), a.get("W"), a.get("k"), a.get("valid"))
    require(a.get("ok") and a["sampler_backend"] == "cuda"
            and got == (full.estimate, full.W, full.k, full.valid),
            f"gateway (a): {a} differs from phase full")
    t0 = time.perf_counter()
    a2 = wire.ask({"id": 2, "tenant": "wiki", "motif": "M4-2",
                   "delta": delta, "k": k_wit, "witnesses": 8})
    walls["m42_witnesses"] = time.perf_counter() - t0
    with Uncounted(*kernels):
        direct = Session(g, cfg).submit(
            Request("M4-2", delta, k_wit, witnesses=8)).result()
        torch.cuda.empty_cache()
    require(a2.get("ok") and len(direct.witnesses) == 8
            and (a2["W"], a2["valid"], a2["estimate"]) == (
                direct.W, direct.valid, direct.estimate)
            and a2["witnesses"] == wire_witnesses(direct),
            "gateway (a): M4-2 witnesses differ from a direct request")
    progress = [ln for ln in wire.lines if ln.get("progress")
                and ln.get("id") == 2]
    require(len(progress) == -(-k_wit // chunk // cfg.checkpoint_every),
            f"gateway (a): {len(progress)} witness progress lines")

    # (b) a stream tenant with a WAL, against a direct StreamingSession
    order = np.argsort(g.t, kind="stable")[:2 * GATEWAY_BATCH]
    batches = [order[:GATEWAY_BATCH], order[GATEWAY_BATCH:]]
    live = {"cmd": "open_tenant", "tenant": "live", "stream": True,
            "wal": True}
    sub = {"cmd": "subscribe", "tenant": "live", "motif": "M4-2",
           "delta": delta, "k": k_wit, "witnesses": 4}
    require(wire.ask(live).get("ok") and wire.ask(sub).get("ok"),
            "gateway (b): stream tenant not opened")
    epochs = []
    for idx in batches:
        edges = np.stack([g.src[idx], g.dst[idx], g.t[idx]], 1).tolist()
        ing = wire.ask({"cmd": "ingest", "tenant": "live", "edges": edges})
        require(ing.get("ingested") == len(idx), f"gateway (b): {ing}")
        t0 = time.perf_counter()
        adv = wire.ask({"cmd": "advance", "tenant": "live"})
        walls.setdefault("advance", []).append(time.perf_counter() - t0)
        require(adv.get("ok"), f"gateway (b): advance {adv}")
        epochs.append(next(ln for ln in wire.lines
                           if ln.get("tenant") == "live" and "sub" in ln
                           and ln.get("epoch") == adv["epoch"]))
    with Uncounted(*kernels):
        ss = StreamingSession(config=cfg)
        ss.subscribe(StandingQuery("M4-2", delta, k_wit, witnesses=4))
        direct_epochs = []
        for idx in batches + [None]:
            if idx is not None:
                ss.ingest(g.src[idx], g.dst[idx], g.t[idx])
            direct_epochs.append(ss.advance().results[0])
        ss.close()
        torch.cuda.empty_cache()
    for ep, want in zip(epochs, direct_epochs):
        require((ep["W"], ep["valid"], ep["estimate"], ep["witnesses"])
                == (want.W, want.valid, want.estimate,
                    wire_witnesses(want)),
                f"gateway (b): epoch {ep['epoch']} differs from a direct "
                "StreamingSession")
    closed = wire.ask({"cmd": "close_tenant", "tenant": "live"})
    reopened = wire.ask(live)
    require(closed.get("ok") and reopened.get("recovered")
            and (reopened["epoch"], reopened["buffered"]) == (2, 0),
            f"gateway (b): reopen {reopened}")
    wire.ask(sub)
    adv = wire.ask({"cmd": "advance", "tenant": "live"})
    ep3 = next(ln for ln in wire.lines if ln.get("tenant") == "live"
               and "sub" in ln and ln.get("epoch") == adv.get("epoch"))
    want = direct_epochs[2]
    require(adv.get("epoch") == 2 and (ep3["W"], ep3["valid"],
                                       ep3["estimate"]) == (
                want.W, want.valid, want.estimate),
            "gateway (b): the recovered stream's next epoch differs from "
            "the live one's")

    # (c) the retry ladder on the card
    RSTATS.reset()
    with FaultInjector([FaultSpec("engine.dispatch", hits=(0, 1, 2),
                                  tag="cuda")]) as inj:
        t0 = time.perf_counter()
        c = wire.ask({"id": 3, **m53})
        walls["m53_laddered"] = time.perf_counter() - t0
    health = wire.ask({"cmd": "health"})
    res_block = health["resilience"]
    require(c.get("ok") and (c["estimate"], c["W"], c["k"], c["valid"])
            == got and "dispatch window halved to 32 " in c[
                "fallback_reason"],
            f"gateway (c): laddered answer {c}")
    require(res_block["retries"] == 3 and res_block["ladder_steps"] == 1
            and sum(f for *_, f in inj.log) == 3,
            f"gateway (c): resilience {res_block}, log {inj.log[:4]}")
    try:
        torch.empty(2 * torch.cuda.get_device_properties(0).total_memory,
                    dtype=torch.uint8, device="cuda")
        oom_kind = None
    except torch.cuda.OutOfMemoryError as e:
        oom_kind = classify(e)
    require(oom_kind == "retryable", f"gateway (c): a card OOM classified "
            f"{oom_kind}")

    # (d) the telemetry verbs
    status = obs.profile_status()
    require(status["error"] is None and status["captured"] == 2
            and status["file"] and os.path.exists(status["file"]),
            f"gateway (d): profile {status}")
    with open(status["file"]) as f:
        events = json.load(f)["traceEvents"]
    sampler_events = [e for e in events if e.get("cat") == "kernel"
                      and "tree_sampler_kernel" in e.get("name", "")]
    require(sampler_events, "gateway (d): the profile holds no "
            "tree-sampler kernel event")
    trace = wire.ask({"cmd": "trace"})
    intake = [s for s in trace["spans"] if s["name"] == "gateway.intake"
              and s.get("attrs", {}).get("id") == 1]
    require(len(intake) == 1, "gateway (d): no intake span of (a)")
    chain = [s for s in trace["spans"] if s["trace"] == intake[0]["trace"]]
    names = {s["name"] for s in chain}
    need = {"gateway.intake", "stage.queue_wait", "session.drain",
            "engine.dispatch", "gateway.emit"}
    require(need <= names, f"gateway (d): (a)'s chain {sorted(names)}")
    metrics = wire.ask({"cmd": "metrics"})["text"]
    require("repro_resilience_retries_total 3" in metrics.splitlines()
            and 'repro_stage_seconds_bucket{stage="dispatch"' in metrics
            and 'repro_stage_seconds_count{stage="device"}' in metrics,
            "gateway (d): metrics lack the retries or stage histograms")
    spans_recorded = obs.RECORDER.recorded
    profile_bytes = os.path.getsize(status["file"])
    served = wire.close()
    launches = {"interval_weight": dep_sum.launches,
                "tree_sampler": tree_sampler_keyed.launches}
    require(all(v > 0 for v in launches.values()),
            f"gateway: launches {launches}")
    obs.set_level(None)
    obs.set_ring(4096)
    obs.RECORDER.clear()
    tmp.cleanup()
    torch.cuda.empty_cache()

    # (e) obs overhead: paired runs, off / trace / trace / off
    overhead = {"off": [], "trace": []}
    with Uncounted(*kernels):
        for lvl in ("off", "trace", "trace", "off"):
            obs.set_level(lvl)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = estimate(g, get_motif(full.motif), delta, k, seed=0,
                         chunk=chunk)
            overhead[lvl].append(time.perf_counter() - t0)
            require(same_result(r, full), f"(e): {lvl} estimate differs")
        obs.set_level(None)
        obs.RECORDER.clear()
        torch.cuda.empty_cache()

        # (f) card against CPU on the small wire script
        answers = {}
        for device in ("cpu", "cuda"):
            out = io.StringIO()
            gateway_serve_loop(
                EstimateConfig(chunk=256, checkpoint_every=2,
                               coalesce_window_s=60.0, device=device),
                infile=io.StringIO("".join(json.dumps(ln) + "\n" for ln
                                           in gateway_small_script())),
                outfile=out)
            answers[device] = keyed_answers(
                json.loads(ln) for ln in out.getvalue().splitlines())
        require(answers["cuda"] == answers["cpu"],
                "gateway (f): card answers differ from the CPU's")

    requests = [ln for ln in wire.lines if "id" in ln
                and not ln.get("progress")]
    emit({"phase": "gateway", "tenants": 2, "requests": len(requests),
          "served": served, "k": k, "k_witness": k_wit,
          "wall_s": walls, "wall_per_request_s": (
              walls["m53"] + walls["m42_witnesses"]
              + walls["m53_laddered"]) / 3,
          "spans_recorded": spans_recorded,
          "retries": res_block["retries"],
          "ladder_steps": res_block["ladder_steps"],
          "fallback_reason": c["fallback_reason"],
          "oom_classified": oom_kind,
          "profile_bytes": profile_bytes,
          "profile_sampler_events": len(sampler_events),
          "chain": sorted(names), "epochs": [
              {k_: ep[k_] for k_ in ("epoch", "W", "valid", "estimate")}
              for ep in epochs + [ep3]],
          "obs_overhead_s": overhead, "card_equal_cpu": True,
          "launches": launches, "phase_s": time.perf_counter() - t_phase})
    return launches


def phase_mesh(g, motif_name: str, delta: int, k: int, chunk: int, full,
               cohort) -> dict:
    """The estimator's data mesh on the card, on the full graph of phase
    ``full`` (alive since then: generating it again costs ~35 s).  The
    launch counters are set to 0 before the 4-shard estimate and read
    after it; the runs it is compared with do not count.  Requires:

    (a) ``estimate(..., mesh=make_estimator_mesh(4))`` (4 shards, placed
        round-robin on the visible cards) equal to phase ``full`` bit for
        bit, with ``mesh_shape`` (4,), the sampler launched once per
        chunk summed over the shards and the dep-sum once per dep-sum,
        its peak memory within 5% of the meshless run's (shards on one
        card share the lead copies; one chunk is live at a time);
    (b) a checkpoint written meshless at k / 2 resumed on the 4-shard
        mesh, and one written on the mesh resumed meshless, both equal
        to ``full``;
    (c) phase ``service``'s cohort on a 3-shard mesh equal to its
        meshless cells, with the meshless launch counts;
    (d) one ``python -m repro_torch.launch.estimate --mesh 4`` process
        on the small graph printing the meshless run's numbers;
    (e) with more than one card, ``make_estimator_mesh()`` (one shard a
        card) equal to ``full`` as well.

    Reads: the wall of the 4-shard estimate against the meshless one
    (meshless, mesh, mesh, meshless), and the device's idle share over
    16 chunks of each under the profiler.
    """
    import gc
    import os

    import torch
    from repro_torch import EstimateConfig, Request, Session, estimate
    from repro_torch import get_motif
    from repro_torch.kernels.interval_weight.ops import dep_sum
    from repro_torch.kernels.tree_sampler.ops import tree_sampler_keyed
    from repro_torch.launch.estimate import parse_graph
    from repro_torch.launch.mesh import make_estimator_mesh
    t_phase = time.perf_counter()
    motif = get_motif(motif_name)
    n_chunks = -(-k // chunk)
    mesh4 = make_estimator_mesh(4)
    cards = torch.cuda.device_count()

    def run(mesh, **kw):
        """(result, wall s, peak bytes above what was live before) of
        one synced estimate."""
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = estimate(g, motif, delta, kw.pop("k", k), seed=0, chunk=chunk,
                       mesh=mesh, **kw)
        torch.cuda.synchronize()
        return (res, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated() - base)

    # (a) the main path on the mesh, counted
    want = dict(interval_weight=dep_sums_of([motif_name]),
                tree_sampler=n_chunks)
    dep_sum.launches = 0
    tree_sampler_keyed.launches = 0
    res, mesh_wall, mesh_peak = run(mesh4)
    launches = dict(interval_weight=dep_sum.launches,
                    tree_sampler=tree_sampler_keyed.launches)
    require(same_result(res, full), "mesh (a): the 4-shard estimate "
            "differs from phase full")
    require(res.mesh_shape == (4,), f"mesh (a): mesh_shape {res.mesh_shape}")
    require(launches == want, f"mesh (a): launches {launches}, want one "
            f"sampler launch per chunk over the shards and one dep-sum "
            f"launch per dep-sum: {want}")
    _, wall, peak = run(None)
    walls = {"meshless": [wall], "mesh4": [mesh_wall]}
    walls["mesh4"].append(run(mesh4)[1])
    walls["meshless"].append(run(None)[1])
    # shards sharing the card share the lead copies, and one chunk is
    # live at a time: the mesh holds no more than the meshless run
    require(mesh_peak <= 1.05 * peak, f"mesh (a): peak {mesh_peak} bytes "
            f"on 4 shards of one card against {peak} meshless")

    # (b) checkpoints across mesh shapes
    path = ROOT / "build" / "mesh_checkpoint.json"
    path.parent.mkdir(exist_ok=True)
    for first, then in ((None, mesh4), (mesh4, None)):
        path.unlink(missing_ok=True)
        run(first, k=k // 2, checkpoint_path=str(path))
        resumed = run(then, checkpoint_path=str(path))[0]
        done = json.loads(path.read_text())["chunks_done"]
        require(done == n_chunks and same_result(resumed, full),
                f"mesh (b): written on {first and first.shape}, resumed on "
                f"{then and then.shape}: not the unbroken run")
    path.unlink()

    # (c) the service cohort on 3 shards
    dep_sum.launches = 0
    tree_sampler_keyed.launches = 0
    t0 = time.perf_counter()
    session = Session(g, EstimateConfig(chunk=chunk),
                      mesh=make_estimator_mesh(3))
    results = [h.result() for h in session.submit_many(
        [Request(m, delta, k, seed=s) for m, s in cohort["cells"]])]
    cohort_wall = time.perf_counter() - t0
    cohort_launches = dict(interval_weight=dep_sum.launches,
                           tree_sampler=tree_sampler_keyed.launches)
    del session
    for (m, s), got, want_ in zip(cohort["cells"], results,
                                  cohort["results"]):
        require(same_result(got, want_) and got.mesh_shape == (3,),
                f"mesh (c): cohort cell ({m}, {s}) on 3 shards differs from "
                "the meshless cohort")
    want = dict(interval_weight=dep_sums_of(cohort["motifs"]),
                tree_sampler=n_chunks)
    require(cohort_launches == want, f"mesh (c): cohort launches "
            f"{cohort_launches}, want {want}")

    # idle share: 16 chunks of each on a warm planner, profiled
    idle = {}
    for name, mesh in (("meshless", None), ("mesh4", mesh4)):
        session = Session(g, EstimateConfig(chunk=chunk), mesh=mesh)
        session.planner.plan(motif, delta)
        prof = device_profile(lambda: session.submit(
            Request(motif, delta, 16 * chunk)).result())
        idle[name] = {kk: prof[kk] for kk in (
            "profiled_wall_s", "device_busy_s", "device_idle_share",
            "kernel_launches")}
        del session
    torch.cuda.empty_cache()

    # (d) the CLI with --mesh 4 on the small graph
    name, sdelta, sk, seed, _ = SMALL_CASES[0]
    small = estimate(parse_graph(SMALL_GRAPH), get_motif(name), sdelta, sk,
                     seed=seed, chunk=256)
    cmd = [sys.executable, "-m", "repro_torch.launch.estimate", "--graph",
           SMALL_GRAPH, "--motif", name, "--delta", str(sdelta), "--k",
           str(sk), "--seed", str(seed), "--chunk", "256", "--mesh", "4"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         cwd=ROOT)
    require(out.returncode == 0, f"mesh (d): the CLI exited "
            f"{out.returncode}: {out.stderr[-2000:]}")
    lines = out.stdout.splitlines()
    require("mesh={'data': 4}" in lines[0]
            and lines[1].split("(")[0] == small.summary().split("(")[0],
            f"mesh (d): the CLI printed {lines[:2]}, the meshless run "
            f"{small.summary()}")

    # (e) one shard a card
    spans = None
    if cards > 1:
        every = make_estimator_mesh()
        res_every = run(every)[0]
        require(same_result(res_every, full)
                and res_every.mesh_shape == (cards,),
                f"mesh (e): the {cards}-card mesh differs from phase full")
        spans = [str(d) for d in every.devices]

    emit({"phase": "mesh", "motif": motif_name, "delta": delta, "k": k,
          "chunk": chunk, "cards": cards,
          "shards_devices": [str(d) for d in mesh4.devices],
          "equal_full": True, "mesh_shape": list(res.mesh_shape),
          "launches": launches, "wall_s": walls,
          "peak_mem_bytes": {"meshless": peak, "mesh4": mesh_peak},
          "mesh_over_meshless": sum(walls["mesh4"]) / sum(walls["meshless"]),
          "checkpoints_across_shapes_equal": True,
          "cohort_3_shards_equal": True, "cohort_wall_s": cohort_wall,
          "cohort_launches": cohort_launches, "profile_16_chunks": idle,
          "cli": lines[:2], "mesh_every_card": spans or (
              f"not run: {cards} card visible, make_estimator_mesh() is "
              "one shard"),
          "phase_s": time.perf_counter() - t_phase})
    return launches


def same_graph(a, b) -> bool:
    """Two snapshots equal array for array."""
    import dataclasses

    import numpy as np
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            if x.dtype != y.dtype or not np.array_equal(x, y):
                return False
        elif x != y:
            return False
    return True


def phase_breakdown(g, motif_name: str, delta: int, chunk: int,
                    n_chunks: int = 16) -> None:
    """Where a sampling chunk's time goes, on the main path's tree.

    Host clock around each stage with a device sync after it (the
    sampler kernel with its own draws, the vertex map, validation +
    DeriveCnt), then one ``torch.profiler`` pass over the same chunks for
    the device-busy time, the idle share and the device kernels per
    chunk; and the kernels the host-side draws (``prepare_draws``, which
    the kernel replaced) take for one chunk.
    """
    import torch
    from repro_torch import choose_tree, get_motif
    from repro_torch.core import rng
    from repro_torch.core.sampler import vertex_map
    from repro_torch.core.validate import make_count_fn
    from repro_torch.kernels.tree_sampler.ops import (build_schedule,
                                                      prepare_draws,
                                                      tree_sampler_keyed)
    dev = g.device_arrays("cuda")
    tree, wts = choose_tree(g, get_motif(motif_name), delta, dev=dev)
    schedule = build_schedule(tree)
    count = make_count_fn(tree, chunk)
    keys = rng.fold_in(rng.PRNGKey(0), torch.arange(n_chunks)).cuda()

    def stages(j, sync):
        marks = []

        def mark():
            if sync:
                torch.cuda.synchronize()
            marks.append(time.perf_counter())
        mark()
        edges, window = tree_sampler_keyed(schedule, tree.root,
                                           tree.num_edges, dev, wts,
                                           keys[j], chunk)
        mark()
        samples = dict(edges=edges, window=window,
                       phi_v=vertex_map(tree, dev, edges))
        mark()
        out = count(dev, wts, samples)
        torch.stack([v.sum() for v in out.values()]).tolist()
        mark()
        return [b - a for a, b in zip(marks, marks[1:])]

    stages(0, True)                               # warm
    per = [stages(j, True) for j in range(n_chunks)]
    names = ("sample", "vertex_map", "validate")
    ms = {n: 1e3 * sum(p[i] for p in per) / n_chunks
          for i, n in enumerate(names)}
    prof = device_profile(lambda: [stages(j, False)
                                   for j in range(n_chunks)])
    draws = device_profile(lambda: prepare_draws(tree, wts, keys[0], chunk))
    emit({"phase": "breakdown", "chunks": n_chunks, "chunk": chunk,
          "host_ms_per_chunk_synced": ms,
          "device_kernels_per_chunk": prof["kernel_launches"] / n_chunks,
          "prepare_draws_kernels_per_chunk": draws["kernel_launches"],
          **prof})


def rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def sfu_bound_ms(pairs: int, softcap: float) -> float:
    """The special-function floor of the sm90 flash kernel: one ex2 per
    attended pair for the softmax, plus one ex2 and one rcp for the
    softcap's tanh, at 16 a clock per SM."""
    return pairs * (3 if softcap else 1) / SFU_OPS_PER_S * 1e3


def sdpa_ms(q, k, v, reps: int = 5) -> tuple[float, bool]:
    """The yardstick: ``scaled_dot_product_attention`` on the same causal
    GQA work (no softcap, no window), in its ``[B, H, S, D]`` layout;
    returns its time and whether it took the GQA heads as they are."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    G = q.shape[2] // k.shape[2]
    kw = {}
    if G > 1:
        try:
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
            kw = dict(enable_gqa=True)
        except TypeError:              # a torch without enable_gqa
            kt, vt = (x.repeat_interleave(G, dim=1) for x in (kt, vt))
    ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, **kw), reps=reps)
    return ms, G == 1 or bool(kw)


def unrounded_readings(got, want, base) -> dict:
    """How far the kernel's output sits from the default plain version
    (p kept in f32), and how far the fault "p not rounded" moves the
    plain version: printed, not gated (about one bf16 rounding of p)."""
    return dict(rel_l2_to_unrounded=rel_l2(got, base),
                fault_p_not_rounded_rel_l2=rel_l2(base, want))


def phase_flash_attention() -> tuple[dict, dict]:
    """The sm90 kernel against its plain version on its own trajectory
    (``round_p=True``: p rounded to bf16 before P.V) at the prefill's
    shapes (Gemma-2-27B, 2 x 8192, bf16): one local and one global layer,
    one global layer with q x 8 so that the scores reach the softcap, and
    the kernel beside ``scaled_dot_product_attention`` without softcap;
    then the MoE prefill's shapes (``flash_moe_case``) and the CUDA-core
    kernel at the f32 check's shapes (``flash_simt_case``) and at
    ``FLASH_SIMT_SHAPES`` (``flash_simt_shapes``).

    Each case also reads how far a known fault would move the output,
    computed with the plain version, and fails unless that is ten times
    the limit: the check must be able to see it at these shapes.  The
    CUDA-core kernel (the earlier design) is timed on the same work
    through ``_flash_attention_simt``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import (
        _flash_attention_simt, attended_pairs, flash_attention)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.testing import p_rounding_allowance
    cfg = get_config(LM_ARCH)
    B, S, Hq, Hkv, D = (LM_BATCH, LM_PROMPT, cfg.n_heads, cfg.n_kv_heads,
                        cfg.hd)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16)
               for shape in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())      # q, k, v in, o out
    cap, win = cfg.attn_softcap, cfg.sliding_window
    # (kind, window, q scale, the fault it must see: its kwargs for the
    # plain version); only the q scale 1 cases are the path's and timed
    cases = (("local", win, 1, ("oldest 64-key tile of the window lost",
                                dict(window=win - 64))),
             ("global", 0, 1, None),
             ("global, q x 8", 0, 8, ("softcap ignored",
                                      dict(attn_softcap=0.0))))
    checked, timed = [], []
    for kind, window, scale, fault in cases:
        qs = q * scale                                # exact in bf16
        kw = dict(causal=True, window=window, attn_softcap=cap)
        n90 = flash_attention.launches_sm90
        got = flash_attention(qs, k, v, **kw)
        want = flash_attention_ref(qs, k, v, round_p=True, **kw)
        torch.cuda.synchronize()
        require(flash_attention.launches_sm90 == n90 + 1,
                f"flash_attention {kind}: not through the sm90 kernel")
        err = (got.float() - want.float()).abs()
        limit = FA_ATOL + FA_RTOL * want.float().abs()
        allow = p_rounding_allowance(qs, k, v, **kw)
        rec = dict(kind=kind, window=window, softcap=cap, q_scale=scale,
                   max_abs_err=float(err.max()), rel_l2=rel_l2(got, want),
                   want_rms=float(want.float().pow(2).mean().sqrt()),
                   p_flip_allowance_max=float(allow.max()),
                   over_limit_without_allowance=int((err > limit).sum()))
        require(bool(torch.isfinite(got).all()), f"{kind}: non-finite")
        require(bool((err <= limit + allow).all())
                and rec["rel_l2"] <= FA_REL_L2,
                f"flash_attention {kind}: max |err| {rec['max_abs_err']} "
                f"(atol {FA_ATOL}, rtol {FA_RTOL}, plus the p-rounding "
                f"allowance), relative L2 {rec['rel_l2']} (limit "
                f"{FA_REL_L2})")
        del err, limit, allow
        base = flash_attention_ref(qs, k, v, **kw)
        rec.update(unrounded_readings(got, want, base))
        del got, base
        if fault is not None:
            name, change = fault
            rec["fault"] = name
            rec["fault_rel_l2"] = rel_l2(
                flash_attention_ref(qs, k, v, round_p=True,
                                    **{**kw, **change}), want)
            require(rec["fault_rel_l2"] >= FA_FAULT_MIN,
                    f"flash_attention {kind}: the check cannot see "
                    f"'{name}' (relative L2 {rec['fault_rel_l2']})")
        del want
        if scale == 1:
            pairs = attended_pairs(S, S, True, window)
            flops = 4 * D * pairs * B * Hq
            rec.update(
                pairs=pairs, flops=flops, bytes=nbytes,
                ms=cuda_ms(lambda: flash_attention(q, k, v, **kw), reps=10),
                simt_ms=cuda_ms(lambda: _flash_attention_simt(q, k, v, **kw),
                                reps=3),
                plain_ms=cuda_ms(lambda: flash_attention_ref(
                    q, k, v, round_p=True, **kw), reps=1),
                bound_ms=max(flops / BF16_FLOPS_PER_S,
                             nbytes / HBM_BYTES_PER_S) * 1e3,
                sfu_bound_ms=sfu_bound_ms(pairs * B * Hq, cap))
            timed.append(rec)
        checked.append(rec)
        emit({"phase": "flash_attention", "kernel": "flash_attention_sm90",
              **rec})
    moe = flash_moe_case()
    # the yardstick: one PyTorch call on the global layer without softcap
    kw = dict(causal=True, window=0, attn_softcap=0.0)
    pairs = attended_pairs(S, S, True, 0) * B * Hq
    ms_nocap = cuda_ms(lambda: flash_attention(q, k, v, **kw), reps=10)
    simt_nocap = cuda_ms(lambda: _flash_attention_simt(q, k, v, **kw),
                         reps=3)
    lib_ms, lib_gqa = sdpa_ms(q, k, v)
    library_case = "global layer, causal, softcap 0"
    emit({"phase": "flash_attention", "kind": library_case,
          "ms": ms_nocap, "simt_ms": simt_nocap, "sdpa_ms": lib_ms,
          "sdpa_gqa": lib_gqa, "sfu_bound_ms": sfu_bound_ms(pairs, 0.0)})
    del q, k, v
    simt = flash_simt_case()
    simt.update(flash_simt_shapes())
    n = len(timed)
    sm90 = dict(
        name="flash_attention_sm90", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention_sm90.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:94",
        max_abs_err=max(c["max_abs_err"] for c in checked + [moe]),
        # per launch, over the prefill's even mix of local and global
        ms=sum(c["ms"] for c in timed) / n,
        plain_ms=sum(c["plain_ms"] for c in timed) / n,
        bound_ms=sum(c["bound_ms"] for c in timed) / n,
        bound_by=("operations" if sum(c["flops"] for c in timed)
                  / BF16_FLOPS_PER_S >= n * nbytes / HBM_BYTES_PER_S
                  else "bytes"),
        # SDPA has no softcap or window: it is paired with the kernel's
        # time on the same work, not with the path's mean above
        library_ms=lib_ms, library_case=library_case,
        ms_library_case=ms_nocap, simt_ms_library_case=simt_nocap,
        sfu_bound_ms=sum(c["sfu_bound_ms"] for c in timed) / n,
        simt_ms=sum(c["simt_ms"] for c in timed) / n,
        **{f"moe_{key}": moe[key] for key in (
            "ms", "simt_ms", "plain_ms", "bound_ms", "sfu_bound_ms",
            "library_ms", "max_abs_err", "rel_l2")})
    return sm90, simt


def diagonal_tile_lost(visible):
    """``visible`` with each query's own 64-key tile masked out (past the
    first tile, whose rows would see no key): the fault of a causal
    kernel that stops one tile early."""
    def faulty(qpos, kpos, causal, window):
        same = ((qpos[:, None] // 64 == kpos[None, :] // 64)
                & (qpos[:, None] >= 64))
        return visible(qpos, kpos, causal, window) & ~same
    return faulty


def diagonal_fault(q, k, v, kw, **ref_kw):
    """The plain version with each query's diagonal 64-key tile lost."""
    from repro_torch.kernels.flash_attention import ref
    own = ref.visible
    ref.visible = diagonal_tile_lost(own)
    try:
        return ref.flash_attention_ref(q, k, v, **kw, **ref_kw)
    finally:
        ref.visible = own


def flash_moe_case() -> dict:
    """The sm90 kernel against its plain version (``round_p=True``) at
    the MoE prefill's shapes (Qwen1.5-MoE-A2.7B, 2 x 8192, bf16): MHA (one
    query head per kv head), causal, no window, no softcap; limits read
    from the output's scale (``check_close``), and the fault of a lost
    diagonal 64-key tile read with the plain version.  Timed beside the
    CUDA-core kernel and ``scaled_dot_product_attention``, which computes
    this same function (p kept in f32)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import (
        _flash_attention_simt, attended_pairs, flash_attention)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.testing import p_rounding_allowance
    cfg = get_config(MOE_ARCH)
    B, S, H, D = LM_BATCH, LM_PROMPT, cfg.n_heads, cfg.hd
    require(cfg.n_kv_heads == H, f"{MOE_ARCH} is not MHA")
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    kw = dict(causal=True, window=0, attn_softcap=0.0)
    what = "flash_attention MoE prefill"
    n90 = flash_attention.launches_sm90
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, round_p=True, **kw)
    require(flash_attention.launches_sm90 == n90 + 1,
            f"{what}: not through the sm90 kernel")
    rec = check_close(what, got, want, "bfloat16",
                      allow=p_rounding_allowance(q, k, v, **kw))
    base = flash_attention_ref(q, k, v, **kw)
    rec.update(unrounded_readings(got, want, base))
    del got, base
    rec["fault"] = "each query's diagonal 64-key tile lost"
    rec["fault_rel_l2"] = check_fault(
        what, rec["fault"], diagonal_fault(q, k, v, kw, round_p=True), want,
        "bfloat16")
    del want
    pairs = attended_pairs(S, S, True, 0)
    flops = 4 * D * pairs * B * H
    nbytes = 2 * 4 * q.numel()                        # q, k, v in, o out
    lib_ms, _ = sdpa_ms(q, k, v)
    rec.update(
        B=B, S=S, Hq=H, Hkv=H, D=D, window=0, softcap=0.0, pairs=pairs,
        flops=flops, bytes=nbytes,
        ms=cuda_ms(lambda: flash_attention(q, k, v, **kw), reps=10),
        simt_ms=cuda_ms(lambda: _flash_attention_simt(q, k, v, **kw),
                        reps=3),
        plain_ms=cuda_ms(lambda: flash_attention_ref(q, k, v, round_p=True,
                                                     **kw), reps=1),
        bound_ms=max(flops / BF16_FLOPS_PER_S,
                     nbytes / HBM_BYTES_PER_S) * 1e3,
        sfu_bound_ms=sfu_bound_ms(pairs * B * H, 0.0), library_ms=lib_ms)
    emit({"phase": "flash_attention", "kernel": "flash_attention_sm90",
          "kind": "MoE prefill (Qwen1.5-MoE, MHA, causal, no window, "
          "no softcap)", **rec})
    return rec


def flash_simt_case() -> dict:
    """The CUDA-core kernel where the path runs it: the f32 check of the
    MoE architecture (``phase_moe_check``: 2 x 1032 tokens, 16/16 heads
    of 128, causal, no window, no softcap, f32).  Against its plain
    version under ``KERNEL_TOL["float32"]``, with the lost-diagonal-tile
    fault; timed beside ``scaled_dot_product_attention`` in f32."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import (attended_pairs,
                                                         flash_attention)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    cfg = get_config(MOE_ARCH)
    B, S, H, D = LM_BATCH, MOE_CHECK_PROMPT + MOE_CHECK_AT, cfg.n_heads, \
        cfg.hd
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda")
               for _ in range(3))
    kw = dict(causal=True, window=0, attn_softcap=0.0)
    what = "flash_attention f32 check"
    n = flash_attention.launches_simt
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    require(flash_attention.launches_simt == n + 1,
            f"{what}: not through the CUDA-core kernel")
    rec = check_close(what, got, want, "float32")
    del got
    rec["fault"] = "each query's diagonal 64-key tile lost"
    rec["fault_rel_l2"] = check_fault(what, rec["fault"],
                                      diagonal_fault(q, k, v, kw), want,
                                      "float32")
    del want
    pairs = attended_pairs(S, S, True, 0)
    flops = 4 * D * pairs * B * H
    nbytes = 4 * 4 * q.numel()                        # q, k, v in, o out
    ops_s = flops / F32_FLOPS_PER_S
    lib_ms, _ = sdpa_ms(q, k, v, reps=50)
    rec.update(
        B=B, S=S, Hq=H, Hkv=H, D=D, dtype="float32", pairs=pairs,
        flops=flops, bytes=nbytes,
        ms=cuda_ms(lambda: flash_attention(q, k, v, **kw), reps=50),
        plain_ms=cuda_ms(lambda: flash_attention_ref(q, k, v, **kw),
                         reps=3),
        bound_ms=max(ops_s, nbytes / HBM_BYTES_PER_S) * 1e3,
        bound_by=("operations" if ops_s >= nbytes / HBM_BYTES_PER_S
                  else "bytes"), library_ms=lib_ms)
    emit({"phase": "flash_attention", "kernel": "flash_attention",
          "kind": "MoE f32 check (Qwen1.5-MoE, MHA, causal, f32)", **rec})
    return dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:94",
        case="f32 check, 2 x 1032, 16/16 heads of 128",
        **{key: rec[key] for key in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by",
                                     "library_ms")})


def flash_simt_shapes() -> dict:
    """The CUDA-core flash kernel at ``FLASH_SIMT_SHAPES``: each call
    must launch it (``launches_simt`` rises by one) and match its plain
    version under ``KERNEL_TOL``; one line a case, the worst readings
    returned."""
    import torch
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         kernel_for)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    worst = dict(max_abs_err=0.0, rel_l2=0.0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    for dt, B, Sq, Skv, Hq, Hkv, D, causal, window, cap in FLASH_SIMT_SHAPES:
        dtype = getattr(torch, dt)
        require(kernel_for(dtype, D) == "flash_attention",
                f"flash {dt} D {D}: dispatched to {kernel_for(dtype, D)}")
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   for shape in ((B, Sq, Hq, D), (B, Skv, Hkv, D),
                                 (B, Skv, Hkv, D)))
        q, k, v = ((q * (8 if cap else 1)).to(dtype), k.to(dtype),
                   v.to(dtype))
        kw = dict(causal=causal, window=window, attn_softcap=cap)
        what = (f"flash_attention {dt} D {D}, Sq {Sq} / Skv {Skv}, "
                f"{Hq} / {Hkv} heads, {kw}")
        n = flash_attention.launches_simt
        got = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        require(flash_attention.launches_simt == n + 1,
                f"{what}: not through the CUDA-core kernel")
        rec = check_close(what, got, flash_attention_ref(q, k, v, **kw), dt)
        for key in worst:
            worst[key] = max(worst[key], rec[key])
        emit({"phase": "flash_attention", "kernel": "flash_attention",
              "kind": "shape check", "dtype": dt, "B": B, "Sq": Sq,
              "Skv": Skv, "Hq": Hq, "Hkv": Hkv, "D": D, **kw, **rec})
    return dict(shapes_checked=len(FLASH_SIMT_SHAPES),
                shapes_max_abs_err=worst["max_abs_err"],
                shapes_max_rel_l2=worst["rel_l2"])


def segment_matmul_f32_shapes() -> dict:
    """The f32 grouped-GEMM kernel at ``SM_F32_SHAPES`` (identity group
    ids), each call through it and held to its plain version under
    ``KERNEL_TOL["float32"]``; then the last case with block 3's id out
    of range: that block must be NaN and every other equal to the plain
    version.  One line a case, the worst readings returned."""
    import torch
    from repro_torch.kernels.segment_matmul.ops import (kernel_for,
                                                        segment_matmul)
    from repro_torch.kernels.segment_matmul.ref import segment_matmul_ref
    worst = dict(max_abs_err=0.0, rel_l2=0.0)
    gen = torch.Generator(device="cuda").manual_seed(4)
    for case, E, C, K, N in SM_F32_SHAPES:
        require(kernel_for(torch.float32, K, N) == "segment_matmul",
                f"segment_matmul f32 {case}: dispatched elsewhere")
        x = torch.randn((E * C, K), generator=gen, device="cuda")
        w = torch.randn((E, K, N), generator=gen, device="cuda") * K ** -0.5
        groups = torch.arange(E, dtype=torch.int32, device="cuda")
        what = f"segment_matmul f32 {case} ({E} x {C} rows, K {K}, N {N})"
        n = segment_matmul.launches_simt
        got = segment_matmul(x, w, groups)
        torch.cuda.synchronize()
        require(segment_matmul.launches_simt == n + 1,
                f"{what}: not through the f32 kernel")
        want = segment_matmul_ref(x, w, groups)
        rec = check_close(what, got, want, "float32")
        for key in worst:
            worst[key] = max(worst[key], rec[key])
        emit({"phase": "segment_matmul", "kind": "shape check",
              "case": case, "E": E, "C": C, "K": K, "N": N, **rec})
    bad = groups.clone()
    bad[3] = E
    got = segment_matmul(x, w, bad)
    torch.cuda.synchronize()
    block = slice(3 * C, 4 * C)
    rest = torch.ones(E * C, dtype=torch.bool, device="cuda")
    rest[block] = False
    require(bool(torch.isnan(got[block]).all())
            and bool(torch.equal(got[rest], segment_matmul(x, w,
                                                           groups)[rest])),
            f"segment_matmul f32: group id {E} of {E} not marked NaN "
            "alone")
    emit({"phase": "segment_matmul", "kind": "invalid group id",
          "case": SM_F32_SHAPES[-1][0], "block": 3, "id": E,
          "block_nan": True, "other_blocks_equal": True})
    return dict(shapes_checked=len(SM_F32_SHAPES) + 1,
                shapes_max_abs_err=worst["max_abs_err"],
                shapes_max_rel_l2=worst["rel_l2"])


def phase_lm_small() -> None:
    """Card against CPU for the Gemma-2 smoke config on the same numpy
    weights: prefill (S = 20 > window 8, cache 24), then 3 decode steps,
    in f32 without TF32 (tolerance 1e-4: summation order only) and in
    bf16 (5e-2, the bf16 tolerance of tests/test_models_smoke.py)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.convert import lm_from_numpy, numpy_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(LM_ARCH)
    params = numpy_params(cfg, seed=0)
    tokens = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 23)))
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
        runs = []
        for device in ("cpu", "cuda"):
            model = lm_from_numpy(cfg, params, device=device)
            tok = tokens.to(device)
            logits, cache = model.prefill(tok[:, :20], 24,
                                          compute_dtype=dtype)
            out = [logits]
            for s in range(20, 23):
                logits, cache = model.decode_step(cache, tok[:, s:s + 1],
                                                  compute_dtype=dtype)
                out.append(logits)
            runs.append([x.float().cpu() for x in out]
                        + [cache["k"].float().cpu(),
                           cache["v"].float().cpu()])
        err = max(float((a - b).abs().max()) for a, b in zip(*runs))
        ok = all(torch.allclose(a, b, atol=tol, rtol=tol)
                 for a, b in zip(*runs))
        require(ok, f"lm_small {dtype}: card != CPU (max |err| {err})")
        emit({"phase": "lm_small", "arch": cfg.name, "dtype": str(dtype),
              "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
              "tol": tol, "max_abs_err": err, "equal_within_tol": True})


def phase_lm_full() -> dict:
    """Gemma-2-27B at full width: prefill 2 x 8192 tokens, 16 greedy
    decode steps, launch counts read around that run; then the prompt
    plus the first 8 generated tokens prefilled again (S = 8200, ragged)
    against decode step 8's logits."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.interval_weight.ops import dep_sum
    from repro_torch.kernels.tree_sampler.ops import tree_sampler_keyed
    from repro_torch.models.convert import init_lm
    cfg = get_config(LM_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_lm(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))).cuda()
    counters = (flash_attention, dep_sum, tree_sampler_keyed)
    reset_counters(*counters)
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompt, LM_PROMPT + LM_DECODE)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = flash_attention.launches
    prefill_by_kernel = by_kernel(flash_attention)
    require(tuple(logits.shape) == (LM_BATCH, 1, cfg.vocab),
            f"prefill logits shape {tuple(logits.shape)}")
    require(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    generated, step_logits = [], []
    t0 = time.perf_counter()
    for _ in range(LM_DECODE):
        tok = logits[:, -1].argmax(-1, keepdim=True)
        generated.append(tok)
        logits, cache = model.decode_step(cache, tok)
        step_logits.append(logits)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    require(prefill_launches == cfg.n_layers
            and prefill_by_kernel == dict(sm90=cfg.n_layers, simt=0),
            f"flash launches in prefill {prefill_by_kernel}, not "
            f"{cfg.n_layers} of the sm90 kernel")
    require(launches["flash_attention"] == cfg.n_layers,
            f"flash launches in decode: {launches}")
    require(launches["dep_sum"] == launches["tree_sampler_keyed"] == 0,
            f"TIMEST kernels launched on the LM path: {launches}")
    require(all(bool(torch.isfinite(x).all()) for x in step_logits),
            "decode logits not finite")
    require(cache["kv_len"] == LM_PROMPT + LM_DECODE, "kv_len")
    peak = torch.cuda.max_memory_allocated()
    del cache
    torch.cuda.empty_cache()
    # prefill(prompt + generated[:8]) predicts from the same positions as
    # decode step 8 (which consumed generated[7] at position 8199); it is
    # profiled, and so are 2 decode steps after it
    ext = torch.cat([prompt] + generated[:LM_CHECK_AT], dim=1)
    want = step_logits[LM_CHECK_AT - 1][:, -1].float()
    kinds = {"flash_attention": lambda k: "flash_attention" in k,
             "gemm": lambda k: any(w in k.lower() for w in
                                   ("gemm", "cutlass", "xmma", "nvjet",
                                    "cublas"))}
    out = {}
    prof = device_profile(lambda: out.update(zip(
        ("logits", "cache"), model.prefill(ext, ext.shape[1] + 2))),
        kinds)
    emit({"phase": "lm_breakdown", "run": f"prefill S={ext.shape[1]}",
          **prof})
    got = out.pop("logits")[:, -1].float()
    tok = got.argmax(-1, keepdim=True)

    def two_steps():
        cache = out["cache"]
        for _ in range(2):
            _, cache = model.decode_step(cache, tok)
    prof = device_profile(two_steps, kinds)
    emit({"phase": "lm_breakdown", "run": "2 decode steps",
          "ms_per_step": 1e3 * prof["profiled_wall_s"] / 2, **prof})
    del out
    rel = float((got - want).norm() / want.norm())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    require(rel <= LM_CHECK_TOL,
            f"prefill(S={ext.shape[1]}) vs decode step {LM_CHECK_AT}: "
            f"relative L2 {rel} > {LM_CHECK_TOL}")
    emit({"phase": "lm_full", "arch": cfg.name, "batch": LM_BATCH,
          "prompt": LM_PROMPT, "decode_steps": LM_DECODE,
          "params": sum(p.numel() for p in model.parameters()),
          "weight_bytes": weight_bytes, "init_s": init_s,
          "prefill_s": prefill_s,
          "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / prefill_s,
          "decode_ms_per_step": 1e3 * decode_s / LM_DECODE,
          "decode_tokens_per_s": LM_BATCH * LM_DECODE / decode_s,
          "decode_bound_ms": 1e3 * weight_bytes / HBM_BYTES_PER_S,
          "peak_mem_bytes": peak, "launches": launches,
          "prefill_flash_launches": prefill_launches,
          "prefill_flash_launches_by_kernel": prefill_by_kernel,
          "check_S": int(ext.shape[1]), "check_rel_l2": rel,
          "check_tol": LM_CHECK_TOL, "check_argmax_agree": agree})
    return prefill_by_kernel


def phase_segment_matmul() -> tuple[dict, dict]:
    """The grouped-GEMM kernels against their plain version at the MoE
    path's shapes (Qwen1.5-MoE-A2.7B, 64 padded experts): the sm90 kernel
    on the prefill's gate/up (C = 1368 rows per expert, K = 2048,
    N = 1408) and down (K = 1408, N = 2048) products and a decode step's
    (C = 8) gate/up and down, in bf16; the mma.sync / f32 kernel on the
    f32 check run's gate/up and down (C = 2072), then at
    ``SM_F32_SHAPES`` (``segment_matmul_f32_shapes``).  Each case asserts
    which kernel ran.  Two faults are read with the plain version: a
    block that uses the next group's weights, and a segment whose ragged
    last rows are dropped.  The mma.sync kernel is also held to the plain version on
    each bf16 case (``_segment_matmul_simt``).  The bf16 cases are timed
    through the sm90 kernel, through the mma.sync kernel on the same
    work, as ``torch.bmm`` on the same layout, and as the plain
    version."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.segment_matmul.ops import (
        _segment_matmul_simt, kernel_for, segment_matmul)
    from repro_torch.kernels.segment_matmul.ref import segment_matmul_ref
    from repro_torch.models.moe import capacity
    cfg = get_config(MOE_ARCH)
    E, d, ffe = cfg.e_pad, cfg.d_model, cfg.d_expert
    c_prefill = capacity(cfg, LM_BATCH * LM_PROMPT)
    c_decode = capacity(cfg, LM_BATCH)
    c_check = capacity(replace_capacity(cfg),
                       LM_BATCH * (MOE_CHECK_PROMPT + MOE_CHECK_AT))
    gen = torch.Generator(device="cuda").manual_seed(0)
    # (case, C, K, N, dtype)
    bf16 = torch.bfloat16
    cases = (("prefill gate/up", c_prefill, d, ffe, bf16),
             ("prefill down", c_prefill, ffe, d, bf16),
             ("decode gate/up", c_decode, d, ffe, bf16),
             ("decode down", c_decode, ffe, d, bf16),
             ("f32 check gate/up", c_check, d, ffe, torch.float32),
             ("f32 check down", c_check, ffe, d, torch.float32))
    groups = torch.arange(E, dtype=torch.int32, device="cuda")
    recs = {}
    for case, C, K, N, dtype in cases:
        dt = str(dtype).split(".")[1]
        kernel = kernel_for(dtype, K, N)
        require(kernel == ("segment_matmul_sm90" if dtype == bf16
                           else "segment_matmul"),
                f"segment_matmul {case}: dispatched to {kernel}")
        counter = ("launches_sm90" if kernel == "segment_matmul_sm90"
                   else "launches_simt")
        x = torch.randn((E * C, K), generator=gen, device="cuda").to(dtype)
        w = (torch.randn((E, K, N), generator=gen, device="cuda")
             * K ** -0.5).to(dtype)
        n = getattr(segment_matmul, counter)
        got = segment_matmul(x, w, groups)
        want = segment_matmul_ref(x, w, groups)
        torch.cuda.synchronize()
        require(getattr(segment_matmul, counter) == n + 1,
                f"segment_matmul {case}: not through {kernel}")
        rec = dict(case=case, kernel=kernel, dtype=dt, E=E, C=C, K=K, N=N,
                   **check_close(f"segment_matmul {case}", got, want, dt))
        del got
        if dtype == bf16:
            # the mma.sync kernel on the same bf16 work, held to the same
            # limits as on the path it serves (bf16 of odd widths)
            n = segment_matmul.launches_simt
            got = _segment_matmul_simt(x, w, groups)
            torch.cuda.synchronize()
            require(segment_matmul.launches_simt == n + 1,
                    f"segment_matmul {case}: mma.sync kernel not launched")
            rec["simt_max_abs_err"] = check_close(
                f"segment_matmul {case} (mma.sync)", got, want,
                dt)["max_abs_err"]
            del got
        shifted = (groups + 1) % E
        rec["fault_next_group"] = check_fault(
            f"segment_matmul {case}", "a block uses the next group's weights",
            segment_matmul_ref(x, w, torch.cat([shifted[:1], groups[1:]])),
            want, dt)
        tail = C % 128 or min(C, 128)
        dropped = want.clone()
        dropped[E * C - tail:] = 0
        rec["fault_ragged_tail"] = check_fault(
            f"segment_matmul {case}", "a segment's ragged last rows dropped",
            dropped, want, dt)
        del dropped, want
        flops = 2 * E * C * K * N
        nbytes = (E * C * K + E * K * N + E * C * N) * x.element_size()
        ops_s = flops / (BF16_FLOPS_PER_S if dtype == bf16
                         else F32_FLOPS_PER_S)
        reps = 50 if C <= 64 else 10
        rec.update(
            flops=flops, bytes=nbytes,
            ms=cuda_ms(lambda: segment_matmul(x, w, groups), reps=reps),
            plain_ms=cuda_ms(lambda: segment_matmul_ref(x, w, groups),
                             reps=3),
            library_ms=cuda_ms(lambda: torch.bmm(x.view(E, C, K), w),
                               reps=reps),
            bound_ms=max(ops_s, nbytes / HBM_BYTES_PER_S) * 1e3,
            bound_by=("operations" if ops_s >= nbytes / HBM_BYTES_PER_S
                      else "bytes"))
        if dtype == bf16:
            rec["simt_ms"] = cuda_ms(
                lambda: _segment_matmul_simt(x, w, groups),
                reps=reps if C <= 64 else 3)
        del x, w
        recs[case] = rec
        emit({"phase": "segment_matmul", **rec})
    head, f32 = recs["prefill gate/up"], recs["f32 check gate/up"]
    sm90 = dict(
        name="segment_matmul_sm90", route="cuda",
        source="src/repro_torch/kernels/segment_matmul/csrc/"
               "segment_matmul_sm90.cu",
        replaces="src/repro/kernels/segment_matmul/kernel.py:46",
        max_abs_err=max(r["max_abs_err"] for r in recs.values()
                        if r["dtype"] == "bfloat16"),
        # the prefill's gate/up launch; the other three cases beside it
        case=head["case"], ms=head["ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by=head["bound_by"],
        library_ms=head["library_ms"], simt_ms=head["simt_ms"])
    for case, key in (("prefill down", "prefill_down"),
                      ("decode gate/up", "decode"),
                      ("decode down", "decode_down")):
        sm90.update({f"{key}_{k}": recs[case][k] for k in (
            "ms", "simt_ms", "bound_ms", "bound_by", "library_ms")})
    simt = dict(
        name="segment_matmul", route="cuda",
        source="src/repro_torch/kernels/segment_matmul/csrc/"
               "segment_matmul.cu",
        replaces="src/repro/kernels/segment_matmul/kernel.py:46",
        case=f32["case"],
        **{k: f32[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms")},
        # the f32 check's down product (K 1408, N 2048)
        **{f"down_{k}": recs["f32 check down"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")},
        # the same kernel on the four bf16 cases
        bf16_max_abs_err=max(r["simt_max_abs_err"] for r in recs.values()
                             if r["dtype"] == "bfloat16"),
        **segment_matmul_f32_shapes())
    return sm90, simt


def phase_embedding_bag() -> dict:
    """The EmbeddingBag kernel against its plain version: DCN-v2's
    serve_bulk lookup (the full 62,988,288 x 16 bf16 table, 262,144 x 26
    bags of one id, int64 ids as the path makes them) bit for bit in both
    output modes, and equal to ``torch.index_select`` on the same ids (the
    library yardstick: one call, the same function on bags of one),
    beside ``F.embedding_bag``; then multi-hot bags (8 slots, f32 weights,
    30% ``-1`` pads, d 16 and 128) to ``KERNEL_TOL``, reading two faults
    with the plain version (weights ignored, pads not masked), each timed
    beside its bound (this run's ids, the weights and rows of its
    non-pad slots, the output) and ``F.embedding_bag`` (pads as zero
    weights)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.models.recsys import table_offsets
    t0 = time.perf_counter()
    cfg = get_config("dcn-v2")
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = (torch.randn((cfg.v_total, cfg.embed_dim), generator=gen,
                         device="cuda").mul_(0.01).to(torch.bfloat16))
    B = RECSYS_SHAPES["serve_bulk"]["batch"]
    ids = recsys_ids(cfg, B, np.random.default_rng(0))
    gid = (ids + table_offsets(cfg, "cuda")).reshape(-1, 1)  # [B * F, 1]
    got = embedding_bag(table, gid)
    want = embedding_bag_ref(table, gid)
    torch.cuda.synchronize()
    require(torch.equal(got, want),
            "embedding_bag serve_bulk: kernel != plain version bit for bit")
    flat = gid.view(-1)
    require(torch.equal(torch.index_select(table, 0, flat), got),
            "embedding_bag serve_bulk: kernel != torch.index_select")
    # the f32-output mode (a row-sharded table's partial bags): the f32
    # sums, equal to the plain version's and, rounded, to the bf16 output
    got32 = embedding_bag(table, gid, out_dtype=torch.float32)
    want32 = embedding_bag_ref(table, gid, out_dtype=torch.float32)
    torch.cuda.synchronize()
    require(got32.dtype == torch.float32 and torch.equal(got32, want32)
            and torch.equal(got32.to(table.dtype), got),
            "embedding_bag serve_bulk f32 output: kernel != plain version")
    del got, want, got32, want32
    n = gid.shape[0]
    nbytes = n * 8 + 2 * n * cfg.embed_dim * table.element_size()
    ones = torch.ones((n, 1), dtype=table.dtype, device="cuda")
    try:                  # one PyTorch call of the EmbeddingBag itself
        F.embedding_bag(gid, table, mode="sum", per_sample_weights=ones)
        lib_kw = dict(per_sample_weights=ones)
    except RuntimeError:  # a torch without bf16 per-sample weights
        lib_kw = {}
    gather_ms = cuda_ms(lambda: torch.index_select(table, 0, flat), reps=20)
    rec = dict(name="embedding_bag", route="cuda",
               source="src/repro_torch/kernels/embedding_bag/csrc/"
                      "embedding_bag.cu",
               replaces="src/repro/kernels/embedding_bag/kernel.py:38",
               case="serve_bulk, 262,144 x 26 bags of one id, d 16, bf16",
               bags=n, bytes=nbytes,
               ms=cuda_ms(lambda: embedding_bag(table, gid), reps=20),
               plain_ms=cuda_ms(lambda: embedding_bag_ref(table, gid),
                                reps=3),
               library_ms=gather_ms, library="torch.index_select",
               gather_ms=gather_ms,
               f_embedding_bag_ms=cuda_ms(lambda: F.embedding_bag(
                   gid, table, mode="sum", **lib_kw), reps=20),
               f_embedding_bag_weighted=bool(lib_kw),
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               max_abs_err=0.0)
    emit({"phase": "embedding_bag", "equal": True, "equal_f32_output": True,
          "equal_index_select": True,
          **{k: v for k, v in rec.items()
             if k not in ("name", "route", "source", "replaces")}})
    del ones, flat
    rec["multi_hot"] = {}
    for d in (16, 128):
        V, Bm, bag = 1_000_000, 65_536, 8
        tab = torch.randn((V, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        idx = torch.randint(0, V, (Bm, bag), generator=gen, device="cuda")
        idx[torch.rand((Bm, bag), generator=gen, device="cuda") < 0.3] = -1
        w = torch.randn((Bm, bag), generator=gen, device="cuda")
        got = embedding_bag(tab, idx, w)
        want = embedding_bag_ref(tab, idx, w)
        torch.cuda.synchronize()
        what = f"embedding_bag multi-hot d {d}"
        r = check_close(what, got, want, "bfloat16")
        r["fault_weights_ignored"] = check_fault(
            what, "weights ignored", embedding_bag_ref(tab, idx), want,
            "bfloat16")
        r["fault_pads_unmasked"] = check_fault(
            what, "pads not masked",
            embedding_bag_ref(tab, idx.clamp(min=0), w), want, "bfloat16")
        rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
        valid = int((idx >= 0).sum())
        mbytes = idx.numel() * 8 + valid * (4 + d * 2) + Bm * d * 2
        safe = idx.clamp(min=0)
        zw = torch.where(idx >= 0, w, 0.0).to(tab.dtype)
        try:              # bf16 per-sample weights, where torch takes them
            lib_ms = cuda_ms(lambda: F.embedding_bag(
                safe, tab, mode="sum", per_sample_weights=zw), reps=20)
        except RuntimeError:
            lib_ms = None
        r.update(bytes=mbytes, bound_ms=mbytes / HBM_BYTES_PER_S * 1e3,
                 bound_by="bytes", library_ms=lib_ms,
                 ms=cuda_ms(lambda: embedding_bag(tab, idx, w), reps=20))
        case = f"bag {bag}, 30% pads, f32 weights, d {d}, bf16"
        rec["multi_hot"][f"d {d}"] = {k: r[k] for k in (
            "ms", "bound_ms", "max_abs_err")}
        emit({"phase": "embedding_bag", "case": case, "V": V, "B": Bm, **r})
        del tab, idx, w, got, want, safe, zw
    del table, gid
    emit({"phase": "embedding_bag", "seconds": time.perf_counter() - t0})
    return rec


def replace_capacity(cfg):
    """``cfg`` with capacity factor n_experts / top_k: C > T, no drops."""
    import dataclasses
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                               / cfg.top_k)


def phase_moe_small() -> None:
    """Card against CPU for both MoE smoke configs on the same numpy
    weights: prefill (S = 20, cache 24), then 3 decode steps, in f32
    without TF32 (1e-4) and bf16 (5e-2, with the CPU's routes pinned);
    see ``repro_torch.testing``."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.testing import compare, moe_lm_runs
    for arch in ("qwen2-moe-a2.7b", "granite-moe-3b-a800m"):
        cfg = get_smoke_config(arch)
        want = dict(flash_attention=cfg.n_layers,
                    segment_matmul=12 * cfg.n_layers, embedding_bag=0)
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
            runs, launches, flips = moe_lm_runs(arch, dtype, seed=0)
            require(launches[1] == want,
                    f"moe_small {arch}: card launches {launches[1]}")
            err = compare(runs, tol)
            emit({"phase": "moe_small", "arch": cfg.name, "dtype": str(dtype),
                  "tol": tol, "max_abs_err": err, "route_flips": flips,
                  "launches": launches[1], "equal_within_tol": True})


def reset_counters(*fns) -> None:
    for fn in fns:
        fn.launches = 0
        if hasattr(fn, "launches_sm90"):
            fn.launches_sm90 = fn.launches_simt = 0


def by_kernel(fn) -> dict:
    """Launches of each of ``fn``'s two kernels (flash attention, the
    grouped GEMM) since the counters were reset."""
    return dict(sm90=fn.launches_sm90, simt=fn.launches_simt)


class CountDrops:
    """Inside the ``with``, by wrapping ``moe.dispatch_tables``: sum on
    the device the MoE assignments that capacity dropped (one process:
    every expert in the table; read ``dropped`` once, after it) and the
    table rows filled (``filled``), and count the ``T * k``
    assignments, the table rows (``rows``), the rows a table of ``C``
    an expert would have (``rows_at_capacity``) and each table's width
    (``widths``)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.own = moe, moe.dispatch_tables
        self.dropped, self.filled, self.assignments = 0, 0, 0
        self.rows, self.rows_at_capacity, self.widths = 0, 0, []
        moe.dispatch_tables = self.dispatch_tables
        return self

    def __exit__(self, *exc):
        self.moe.dispatch_tables = self.own

    def dispatch_tables(self, cfg, experts, C, *rest):
        slot_token, slot_gatepos = self.own(cfg, experts, C, *rest)
        kept = (slot_token >= 0).sum()
        self.dropped = self.dropped + (experts.numel() - kept)
        self.filled = self.filled + kept
        self.assignments += experts.numel()
        self.rows += slot_token.numel()
        self.rows_at_capacity += slot_token.shape[0] * C
        self.widths.append(slot_token.shape[1])
        return slot_token, slot_gatepos


def phase_moe_full() -> dict:
    """Qwen1.5-MoE-A2.7B at full width and depth: prefill 2 x 8192
    tokens, 16 greedy decode steps, launch counts and capacity drops
    read around that run; then one prefill and 2 decode steps profiled."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.interval_weight.ops import dep_sum
    from repro_torch.kernels.segment_matmul.ops import segment_matmul
    from repro_torch.kernels.tree_sampler.ops import tree_sampler_keyed
    from repro_torch.models.convert import init_lm
    cfg = get_config(MOE_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_lm(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))).cuda()
    counters = (segment_matmul, flash_attention, embedding_bag,
                dep_sum, tree_sampler_keyed)
    reset_counters(*counters)
    t0 = time.perf_counter()
    with CountDrops() as drops:
        logits, cache = model.prefill(prompt, LM_PROMPT + LM_DECODE)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = {fn.__name__: fn.launches for fn in counters}
    prefill_by_kernel = by_kernel(flash_attention)
    prefill_sm = by_kernel(segment_matmul)
    dropped, assigned = int(drops.dropped), drops.assignments
    require(tuple(logits.shape) == (LM_BATCH, 1, cfg.vocab),
            f"prefill logits shape {tuple(logits.shape)}")
    require(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    step_sm = []                  # grouped-GEMM launches of each step
    t0 = time.perf_counter()
    for _ in range(LM_DECODE):
        before = by_kernel(segment_matmul)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        logits, cache = model.decode_step(cache, tok)
        step_sm.append({k: v - before[k]
                        for k, v in by_kernel(segment_matmul).items()})
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    sm_by_kernel = by_kernel(segment_matmul)
    require(bool(torch.isfinite(logits).all()), "decode logits not finite")
    require(cache["kv_len"] == LM_PROMPT + LM_DECODE, "kv_len")
    per_layer = 3 * cfg.n_layers
    require(prefill_launches["segment_matmul"] == per_layer
            and prefill_launches["flash_attention"] == cfg.n_layers
            and prefill_by_kernel == dict(sm90=cfg.n_layers, simt=0),
            f"prefill launches {prefill_launches}, flash by kernel "
            f"{prefill_by_kernel}")
    require(launches["segment_matmul"] == per_layer * (1 + LM_DECODE)
            and launches["flash_attention"] == cfg.n_layers,
            f"decode launches {launches}")
    require(launches["dep_sum"] == launches["tree_sampler_keyed"]
            == launches["embedding_bag"] == 0,
            f"other paths' kernels launched on the MoE path: {launches}")
    require(prefill_sm == dict(sm90=per_layer, simt=0)
            and all(step == dict(sm90=per_layer, simt=0)
                    for step in step_sm),
            f"grouped-GEMM launches by kernel: prefill {prefill_sm}, "
            f"decode steps {step_sm}")
    peak = torch.cuda.max_memory_allocated()
    del cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    kinds = {"segment_matmul": lambda k: "segment_matmul_sm90_kernel" in k,
             "segment_matmul_simt": lambda k: ("sm_bf16_kernel" in k
                                               or "sm_f32_kernel" in k),
             "flash_attention": lambda k: "flash_attention" in k,
             "gemm": lambda k: any(w in k.lower() for w in
                                   ("gemm", "cutlass", "xmma", "nvjet",
                                    "cublas"))}
    out = {}
    prof = device_profile(lambda: out.update(zip(
        ("logits", "cache"), model.prefill(prompt, LM_PROMPT + 2))), kinds)
    emit({"phase": "moe_breakdown", "run": f"prefill S={LM_PROMPT}", **prof})
    tok = out.pop("logits")[:, -1].argmax(-1, keepdim=True)

    def two_steps():
        cache = out["cache"]
        for _ in range(2):
            _, cache = model.decode_step(cache, tok)
    prof = device_profile(two_steps, kinds)
    emit({"phase": "moe_breakdown", "run": "2 decode steps",
          "ms_per_step": 1e3 * prof["profiled_wall_s"] / 2, **prof})
    out.clear()
    rec = {"phase": "moe_full", "arch": cfg.name, "batch": LM_BATCH,
           "prompt": LM_PROMPT, "decode_steps": LM_DECODE,
           "capacity_factor": cfg.capacity_factor,
           "params": sum(p.numel() for p in model.parameters()),
           "weight_bytes": weight_bytes, "init_s": init_s,
           "prefill_s": prefill_s,
           "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / prefill_s,
           "decode_ms_per_step": 1e3 * decode_s / LM_DECODE,
           "decode_tokens_per_s": LM_BATCH * LM_DECODE / decode_s,
           "decode_bound_ms": 1e3 * weight_bytes / HBM_BYTES_PER_S,
           "peak_mem_bytes": peak, "prefill_launches": prefill_launches,
           "prefill_flash_launches_by_kernel": prefill_by_kernel,
           "prefill_segment_matmul_launches_by_kernel": prefill_sm,
           "launches": launches,
           "segment_matmul_launches_by_kernel": sm_by_kernel,
           "segment_matmul_per_decode_step":
               (launches["segment_matmul"]
                - prefill_launches["segment_matmul"]) / LM_DECODE,
           "prefill_assignments": assigned,
           "prefill_dropped": dropped,
           "prefill_drop_share": dropped / assigned}
    emit(rec)
    del model, out
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_moe_check() -> dict:
    """The same architecture in f32 (weights from seed 0) with capacity
    factor n_experts / top_k, so no token is ever dropped: a 2 x 1024
    prompt, 8 greedy decode steps, then prefill(prompt + 8 generated)
    against decode step 8, through the CUDA-core f32 kernels of both
    (segment_matmul.cu, flash_attention.cu) only."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.segment_matmul.ops import segment_matmul
    from repro_torch.models.convert import init_lm
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace_capacity(get_config(MOE_ARCH))
    torch.cuda.reset_peak_memory_stats()
    model = init_lm(cfg, seed=0, device="cuda", dtype=torch.float32)
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (LM_BATCH, MOE_CHECK_PROMPT))).cuda()
    reset_counters(segment_matmul, flash_attention)
    S = MOE_CHECK_PROMPT + MOE_CHECK_AT
    with CountDrops() as drops:
        logits, cache = model.prefill(prompt, S,
                                      compute_dtype=torch.float32)
        generated = []
        for _ in range(MOE_CHECK_AT):
            tok = logits[:, -1].argmax(-1, keepdim=True)
            generated.append(tok)
            logits, cache = model.decode_step(cache, tok,
                                              compute_dtype=torch.float32)
        want = logits[:, -1]
        del cache
        ext = torch.cat([prompt] + generated, dim=1)
        got, _ = model.prefill(ext, S + 1, compute_dtype=torch.float32)
    got = got[:, -1]
    dropped, assigned = int(drops.dropped), drops.assignments
    rel = rel_l2(got, want)
    require(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
            "moe_check: logits not finite")
    require(dropped == 0, f"moe_check: {dropped} assignments dropped")
    flash_by_kernel = by_kernel(flash_attention)
    sm_by_kernel = by_kernel(segment_matmul)
    require(segment_matmul.launches == 3 * cfg.n_layers * (2 + MOE_CHECK_AT)
            and sm_by_kernel == dict(sm90=0, simt=segment_matmul.launches)
            and flash_attention.launches == 2 * cfg.n_layers
            and flash_by_kernel == dict(sm90=0, simt=2 * cfg.n_layers),
            f"moe_check launches: segment_matmul {sm_by_kernel}, flash "
            f"{flash_by_kernel}")
    require(rel <= MOE_CHECK_TOL,
            f"moe_check: prefill(S={S}) vs decode step {MOE_CHECK_AT}: "
            f"relative L2 {rel} > {MOE_CHECK_TOL}")
    emit({"phase": "moe_check", "arch": cfg.name, "dtype": "float32",
          "capacity_factor": cfg.capacity_factor, "prompt": MOE_CHECK_PROMPT,
          "check_S": S, "check_rel_l2": rel, "check_tol": MOE_CHECK_TOL,
          "argmax_agree": float((got.argmax(-1) == want.argmax(-1))
                                .float().mean()),
          "assignments": assigned, "dropped": dropped,
          "segment_matmul_launches": segment_matmul.launches,
          "segment_matmul_launches_by_kernel": sm_by_kernel,
          "flash_launches": flash_attention.launches,
          "flash_launches_by_kernel": flash_by_kernel,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    del model, got, want, logits
    gc.collect()
    torch.cuda.empty_cache()
    return dict(flash=flash_by_kernel, segment_matmul=sm_by_kernel)


def tree_to(tree, device):
    """A nested dict / list of tensors, copied to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def recsys_ids(cfg, B: int, r) -> "torch.Tensor":
    """One id per feature, uniform in ``[0, table_size)``, on the card."""
    import numpy as np
    import torch
    sizes = np.asarray(cfg.table_sizes)
    ids = (r.random((B, len(sizes))) * sizes).astype(np.int64)
    return torch.as_tensor(ids).cuda()


def phase_recsys_small() -> None:
    """Card against CPU for the DCN-v2 smoke config on the same numpy
    weights: forward (one-hot, with pads, and multi-hot) and retrieval,
    in f32 without TF32 (1e-5) and bf16 (5e-2); see
    ``repro_torch.testing``."""
    import torch
    from repro_torch.testing import compare, recsys_runs
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 5e-2)):
        runs, launches = recsys_runs(dtype, seed=0)
        require(launches[1]["embedding_bag"] == 3,
                f"recsys_small: card launches {launches[1]}, not 3 "
                "embedding_bag")
        err = compare(runs, tol)
        emit({"phase": "recsys_small", "arch": "dcn-v2-smoke",
              "dtype": str(dtype), "tol": tol, "max_abs_err": err,
              "equal_within_tol": True})


def phase_recsys_full() -> int:
    """DCN-v2 at full width (random bf16 weights from seed 0): the
    serve_p99 and serve_bulk forwards and the retrieval_cand scoring of
    ``RECSYS_SHAPES``, ids uniform per feature (numpy seed 0), launch
    counts read around the timed calls, then one call of each profiled;
    the first 512 rows of serve_bulk held against the CPU on the same
    weights."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.segment_matmul.ops import segment_matmul
    from repro_torch.models import recsys
    from repro_torch.models.convert import init_recsys
    cfg = get_config("dcn-v2")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_recsys(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    r = np.random.default_rng(0)

    def batch(B):
        return dict(dense=torch.as_tensor(r.standard_normal(
            (B, cfg.n_dense)), dtype=torch.float32).cuda(),
            sparse=recsys_ids(cfg, B, r))
    shapes = RECSYS_SHAPES
    calls = {
        "serve_p99": (batch(shapes["serve_p99"]["batch"]), recsys.forward,
                      shapes["serve_p99"]["batch"]),
        "serve_bulk": (batch(shapes["serve_bulk"]["batch"]), recsys.forward,
                       shapes["serve_bulk"]["batch"])}
    q = batch(1)
    n_cand = shapes["retrieval_cand"]["n_candidates"]
    q["cand_ids"] = torch.as_tensor(
        r.integers(0, cfg.table_sizes[0], n_cand)).cuda()
    calls["retrieval_cand"] = (q, recsys.serve_retrieval, n_cand)
    counters = (embedding_bag, segment_matmul, flash_attention)
    kinds = {"embedding_bag": lambda k: "embedding_bag_kernel" in k,
             "gemm": lambda k: any(w in k.lower() for w in
                                   ("gemm", "cutlass", "xmma", "nvjet",
                                    "cublas"))}
    results, total = {}, 0
    for name, (b, fn, rows) in calls.items():
        for _ in range(2):                               # warm-up
            out = fn(cfg, params, b)
        torch.cuda.synchronize()
        reps = 10
        reset_counters(*counters)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(cfg, params, b)
            torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / reps
        launches = {f.__name__: f.launches for f in counters}
        require(launches["embedding_bag"] == reps
                and launches["segment_matmul"] == launches["flash_attention"]
                == 0, f"recsys {name}: launches {launches}")
        require(tuple(out.shape) == (rows,) and bool(torch.isfinite(out)
                                                     .all()),
                f"recsys {name}: output {tuple(out.shape)} not finite")
        total += launches["embedding_bag"]
        results[name] = out
        CARD_S["dcn-v2", name] = ms / 1e3
        emit({"phase": "recsys_full", "call": name, "rows": rows,
              "ms_per_call": ms, "rows_per_s": rows / ms * 1e3,
              "launches": launches})
        prof = device_profile(lambda: fn(cfg, params, b), kinds)
        emit({"phase": "recsys_breakdown", "call": name, **prof})
    # the first 512 rows of serve_bulk on the CPU, same weights
    b = calls["serve_bulk"][0]
    cpu_params = tree_to(params, "cpu")
    want = recsys.forward(cfg, cpu_params, {k: v[:512].cpu()
                                            for k, v in b.items()})
    got = results["serve_bulk"][:512].cpu()
    err = float((got.float() - want.float()).abs().max())
    require(torch.allclose(got.float(), want.float(), atol=5e-2, rtol=5e-2),
            f"recsys_full: serve_bulk rows 0-511 card != CPU (max |err| "
            f"{err})")
    emit({"phase": "recsys_full", "arch": cfg.name,
          "table_rows": cfg.v_total, "table_bytes":
              params["table"].numel() * params["table"].element_size(),
          "params": cfg.param_count(), "init_s": init_s,
          "cpu_check_rows": 512, "cpu_check_max_abs_err": err,
          "cpu_check_tol": 5e-2, "embedding_bag_launches": total,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    del params, cpu_params, calls, results, q
    gc.collect()
    torch.cuda.empty_cache()
    return total


def phase_train_small() -> None:
    """Card against CPU at smoke size: three AdamW steps of each
    ``repro_torch.testing.TRAIN_SMOKE`` case (GAT, GatedGCN molecules,
    GraphSAGE full graph and sampled blocks, GraphCast, DCN-v2) from the
    same numpy weights and batches, losses and parameters within
    ``TRAIN_SMALL_TOL``; then DCN-v2 smoke through ``run_resumable``,
    killed after step 2 and resumed, equal to the straight run bit for
    bit (batch 4: no id repeats more than twice in a feature, so the
    backward's atomic adds land in one order)."""
    import shutil

    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import build, synthetic_batch
    from repro_torch.testing import TRAIN_SMOKE, compare_train, train_runs
    from repro_torch.train import pytree
    from repro_torch.train.fault_tolerance import run_resumable
    for name, arch, layout in TRAIN_SMOKE:
        tol = TRAIN_SMALL_TOL["dcn-v2" if arch == "dcn-v2" else "gnn"]
        runs, launches = train_runs(name, device="cuda")
        err = compare_train(runs, tol)
        want = 3 if arch == "dcn-v2" else 0
        require(launches[1]["embedding_bag"] == want
                and launches[0]["embedding_bag"] == 0,
                f"train_small {name}: launches {launches}, not {want} "
                "embedding_bag on the card")
        emit({"phase": "train_small", "case": name, "layout": layout,
              "steps": 3, "tol": tol, "max_rel_err": err,
              "losses_card": runs[1][0].tolist(),
              "losses_cpu": runs[0][0].tolist(),
              "launches_card": launches[1]})
    cfg = get_smoke_config("dcn-v2")
    root = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)

    def batches(step, attempt):
        return synthetic_batch(cfg, 4, 0, step * 1000 + attempt, "cuda")
    final = {}
    for run, stops in (("straight", (4,)), ("killed", (2, 4))):
        for total in stops:
            state, do_step = build(cfg, 1e-3, 4, device="cuda")
            state, rep = run_resumable(do_step, state, batches, total,
                                       str(root / run), ckpt_every=1)
        final[run] = (pytree.leaves(state), rep)
    (a, rep_a), (b, rep_b) = final["straight"], final["killed"]
    require(rep_b.resumed_from == 2 and rep_b.steps_run == 2
            and rep_a.steps_run == 4,
            f"train_small resume: {rep_a}, {rep_b}")
    require(all(torch.equal(x, y) for x, y in zip(a, b, strict=True)),
            "train_small: the resumed run differs from the straight run")
    shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "train_small", "case": "dcn-v2 run_resumable",
          "killed_after": 2, "steps": 4, "resumed_from": rep_b.resumed_from,
          "equal": True, "leaves": len(a)})


def layout_of(cell, batch) -> dict:
    """Require a numpy batch to hold the keys, shapes and dtypes of the
    cell's batch argument (``launch.specs``); return its layout."""
    from repro_torch.train import pytree
    want = [(p, tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in pytree.flatten_with_paths(cell.args[2])]
    got = [(p, tuple(x.shape), str(x.dtype))
           for p, x in pytree.flatten_with_paths(batch)]
    require(got == want, f"{cell.arch} x {cell.shape}: generated batch "
            f"{got} is not the cell's layout {want}")
    return {p: list(shape) for p, shape, _ in want}


def gnn_cell(arch: str, shape: str, r) -> tuple:
    """``(cfg, d_in, d_out, numpy batch, readings)`` of one GNN cell: the
    config (the shape's fanout, the cell's remat group), widths and
    batch layout of ``repro_torch.launch.specs.build_cell``, inputs from
    ``r``: a full graph with its edges padded to a multiple of 512
    (GraphCast: its mesh and its three edge sets), sampled GraphSAGE
    blocks over a random graph of the shape's n and m (the shape's
    fanout), or molecules; the batch held to the cell's layout."""
    import numpy as np
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.graphs import NeighborSampler
    from repro_torch.launch.mesh import layout_mesh
    from repro_torch.launch.specs import build_cell
    from repro_torch.testing import (gnn_block_batch, gnn_full_batch,
                                     gnn_molecule_batch)
    cell = build_cell(arch, shape, layout_mesh((1, 1)))
    sh, cfg = GNN_SHAPES[shape], cell.cfg
    d_in, d_out = cell.d_in, cell.d_out
    info = {}
    if shape == "minibatch_lg":
        n, m = sh["n_nodes"], sh["n_edges"]
        t0 = time.perf_counter()
        snd, rcv = r.integers(0, n, m), r.integers(0, n, m)
        t1 = time.perf_counter()
        sampler = NeighborSampler(snd, rcv, n)
        t2 = time.perf_counter()
        del snd, rcv
        feats = r.standard_normal((n, d_in), dtype=np.float32)
        labels = r.integers(0, sh["n_classes"], n)
        t3 = time.perf_counter()
        batch = gnn_block_batch(sampler, r, sh["batch_nodes"],
                                cfg.sample_sizes, feats, labels)
        info = dict(graph_n=n, graph_m=m, edges_gen_s=t1 - t0,
                    sampler_build_s=t2 - t1,
                    sample_blocks_s=time.perf_counter() - t3,
                    table_nodes=len(batch["feats"]),
                    block_edges=[len(b["senders"]) for b in batch["blocks"]])
        del sampler, feats
    elif shape == "molecule":
        batch = gnn_molecule_batch(r, sh["batch"], sh["n_nodes"],
                                   sh["n_edges"], d_in, sh["n_classes"])
    else:
        batch = gnn_full_batch(cfg, r, sh["n_nodes"], sh["n_edges"], d_in,
                               sh["n_classes"])
        info = {k: len(v) for k, v in batch.items() if k.endswith("senders")}
    info["layout"] = layout_of(cell, batch)
    return cfg, d_in, d_out, batch, info


def first_step(loss_fn, params, batch, by_leaf: bool = False) -> dict:
    """The loss and the gradient's f64 norm at ``params`` (one
    ``value_and_grad``; norms summed in slices of 2^24, so no leaf is
    copied whole to f64), with each leaf's norm by its path if
    ``by_leaf``."""
    from repro_torch.train import pytree
    from repro_torch.train.steps import value_and_grad
    loss, grads = value_and_grad(loss_fn)(params, batch)
    leaf = {}
    for path, g in pytree.flatten_with_paths(grads):
        leaf[path] = sum(float(part.double().square().sum())
                         for part in g.reshape(-1).split(1 << 24)) ** 0.5
    out = dict(loss=float(loss),
               grad_norm_f64=sum(x * x for x in leaf.values()) ** 0.5)
    if by_leaf:
        out["leaf_norms_f64"] = leaf
    return out


def hold_first_step(what: str, card: dict, cpu: dict, tol: float,
                    losses=(), looser=None) -> dict:
    """Require every reading of the card's ``first_step`` (loss, norm,
    each leaf's norm) finite and within ``tol`` of the CPU port's (a
    reading whose key ends with a key of ``looser`` within its value),
    and the trained run's ``losses`` finite with the first within
    ``tol`` of the CPU's loss; return the relative errors."""
    import numpy as np
    flat = {}
    for side, d in (("card", card), ("cpu", cpu)):
        for k, v in d.items():
            for kk, x in (v.items() if isinstance(v, dict) else [("", v)]):
                flat.setdefault(k + kk, {})[side] = x
    rel = {k: abs(v["card"] - v["cpu"]) / max(abs(v["cpu"]), 1e-30)
           for k, v in flat.items()}

    def tol_of(key):
        return next((t for end, t in (looser or {}).items()
                     if key.endswith(end)), tol)
    require(all(np.isfinite([v["card"], v["cpu"]]).all()
                for v in flat.values()) and all(np.isfinite(losses))
            and all(r <= tol_of(k) for k, r in rel.items()),
            f"{what}: first step card {card} against CPU {cpu}, relative "
            f"errors {rel} (tol {tol}), losses {losses}")
    if len(losses):
        require(abs(losses[0] - cpu["loss"]) <= tol * abs(cpu["loss"]),
                f"{what}: first loss {losses[0]} against CPU {cpu['loss']}")
    return rel


def phase_gnn_train() -> None:
    """The four GNN configs at full width, each on one ``GNN_SHAPES`` cell
    (``GNN_CELLS``, inputs from numpy seed 0): ``TRAIN_STEPS`` AdamW
    steps on the card, the step time (median of steps 2-5, synced), the
    peak memory and a profiled sixth step; the loss and the gradient's
    norm at the first step's weights held against the CPU port's at the
    same inputs (``TRAIN_FULL_TOL``).  The norm is taken in f64: at full
    depth GraphCast's gradient (the reference's interaction blocks have
    no normalisation) has a sum of squares past f32's range, so the
    optimizer's f32 ``grad_norm`` is inf on both devices (also printed)."""
    import gc
    import statistics
    from functools import partial

    import numpy as np
    import torch
    from repro_torch.models import gnn
    from repro_torch.models.convert import numpy_gnn_params, tree_from_numpy
    from repro_torch.testing import to_torch
    from repro_torch.train import pytree
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_train_step
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    torch.backends.cuda.matmul.allow_tf32 = False       # f32, as the CPU
    for arch, shape in GNN_CELLS:
        t0 = time.perf_counter()
        cfg, d_in, d_out, batch, info = gnn_cell(arch, shape,
                                                 np.random.default_rng(0))
        params = numpy_gnn_params(cfg, d_in, d_out, seed=0)
        setup_s = time.perf_counter() - t0
        loss_fn = partial(gnn.train_loss, cfg)

        def first(device):
            return first_step(loss_fn, tree_from_numpy(params, device=device),
                              to_torch(batch, device))
        t0 = time.perf_counter()
        cpu_first = first("cpu")
        cpu_s = time.perf_counter() - t0
        card_first = first("cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        p = tree_from_numpy(params, device="cuda")
        b = to_torch(batch, "cuda")
        opt = adamw_init(p)
        step = make_train_step(loss_fn, opt_cfg)
        times, losses, opt_norm = [], [], None
        for s in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, opt, m = step(p, opt, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            if opt_norm is None:
                opt_norm = float(m["grad_norm"])
        peak = torch.cuda.max_memory_allocated()
        CARD_S[arch, shape] = statistics.median(times[1:])
        rel = hold_first_step(f"gnn_train {arch} x {shape}", card_first,
                              cpu_first, TRAIN_FULL_TOL, losses)
        prof = device_profile(lambda: step(p, opt, b))
        emit({"phase": "gnn_train", "arch": arch, "shape": shape,
              "params": sum(x.numel() for x in pytree.leaves(p)),
              "d_in": d_in, "d_out": d_out, "steps": TRAIN_STEPS,
              "step_ms_median_2_5": 1e3 * statistics.median(times[1:]),
              "step_ms": [1e3 * t for t in times], "losses": losses,
              "card_first": card_first, "cpu_first": cpu_first,
              "rel_err": rel, "tol": TRAIN_FULL_TOL, "cpu_first_s": cpu_s,
              "optimizer_grad_norm_f32": opt_norm,
              "setup_s": setup_s, "peak_mem_bytes": peak, **info,
              "profiled_step": prof})
        del p, b, opt, step, batch, params
        gc.collect()
        torch.cuda.empty_cache()


class StepSplit:
    """``make_train_step``'s ``mark`` hook: while ``run`` drives a step,
    a CUDA event and the peak memory allocated since the last mark at
    each boundary, so the real step's forward, backward and optimizer
    are timed apart (ms, summed over microbatches) and their peaks read;
    a no-op otherwise."""

    def __init__(self):
        self.marks = None

    def __call__(self, name: str) -> None:
        if self.marks is None:
            return
        import torch
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev, torch.cuda.max_memory_allocated()))
        torch.cuda.reset_peak_memory_stats()

    def run(self, fn) -> tuple:
        """``(fn(), parts)``: ``parts`` maps ``<part>_ms`` and
        ``<part>_peak_bytes`` for each part the step marked."""
        import torch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.marks = []
        try:
            out = fn()
            torch.cuda.synchronize()
            marks = self.marks
        finally:
            self.marks = None
        parts = {}
        for (name, ev, _), (_, nxt, peak) in zip(marks, marks[1:]):
            # a part marked once per microbatch: times summed, peak max
            parts[f"{name}_ms"] = (parts.get(f"{name}_ms", 0.0)
                                   + ev.elapsed_time(nxt))
            parts[f"{name}_peak_bytes"] = max(
                parts.get(f"{name}_peak_bytes", 0), peak)
        return out, parts


def hold_table_grad(what: str, table, gid, gen) -> dict:
    """``recsys.embedding_bag``'s table gradient on the card (one
    ``index_add_`` in f32, cast to bf16) for a random bf16 output
    gradient, held against the plain autograd of ``embedding_bag_ref``
    on the rows it reads (in f32, rounded once to bf16); nothing may
    land outside those rows."""
    import torch
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.models import recsys
    g = torch.randn((gid.shape[0], table.shape[1]), generator=gen,
                    device="cuda").to(torch.bfloat16)
    t1 = table.detach().requires_grad_()
    recsys.embedding_bag(t1, gid).backward(g)
    rows = torch.unique(gid[:, 0])
    t2 = table[rows].float().requires_grad_()
    embedding_bag_ref(t2, torch.searchsorted(rows, gid)).backward(g.float())
    torch.cuda.synchronize()
    check = check_close(what, t1.grad[rows], t2.grad.to(torch.bfloat16),
                        "bfloat16")
    require(int(t1.grad.count_nonzero())
            == int(t1.grad[rows].count_nonzero()),
            f"{what}: gradient outside the rows read")
    return dict(rows=int(rows.numel()), **check)


def phase_recsys_train() -> tuple[int, dict]:
    """DCN-v2 at full width in training (f32 weights, bf16 forward; the
    62,988,288 x 16 table, its two moments and its gradient on the card)
    on ``launch.train``'s step and its ``synthetic_batch`` traffic at
    train_batch = 65,536 (numpy seeds 0, 1000, ...).  At the first
    batch and the initial weights: the embedding_bag kernel equal to
    ``embedding_bag_ref`` bit for bit, the table gradient held to the
    plain autograd (``hold_table_grad``), and the first step against the
    CPU port's: in f32 the loss and every leaf's gradient norm (f64)
    within ``TRAIN_FULL_TOL``; in bf16, as the step trains, the loss
    within the same and every leaf's norm within ``BF16_GRAD_TOL`` of
    the f32 CPU's.  Then ``TRAIN_STEPS`` steps, one embedding_bag launch required per
    step; the step's own forward / backward / optimizer split
    (``StepSplit``, median of three more steps); a profiled step; the
    backward's ``index_add_`` timed beside its bound and
    ``embedding_dense_backward``, and held at the serve_p99 size too.
    Returns the kernel launches of the timed steps and the backward's
    readings."""
    import gc
    import statistics
    from functools import partial

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.launch.train import build, synthetic_batch
    from repro_torch.models import recsys
    cfg = get_config("dcn-v2")
    V, d = cfg.v_total, cfg.embed_dim
    B = RECSYS_SHAPES["train_batch"]["batch"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    split = StepSplit()
    t0 = time.perf_counter()
    state, do_step = build(cfg, 3e-4, TRAIN_STEPS + 2, device="cuda",
                           mark=split)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batches = [synthetic_batch(cfg, B, 0, s * 1000, "cuda")
               for s in range(TRAIN_STEPS)]

    # the path's lookup and table gradient at its own shape
    gid = (batches[0]["sparse"].long()
           + recsys.table_offsets(cfg, "cuda")).reshape(-1, 1)
    table = state["params"]["table"].detach().to(torch.bfloat16)
    got, want = embedding_bag(table, gid), embedding_bag_ref(table, gid)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "recsys_train: embedding_bag kernel "
            "!= plain version bit for bit at train_batch")
    del got, want
    checks = dict(forward_equal=True, backward_train_batch=hold_table_grad(
        "embedding_bag backward train_batch", table, gid, gen))
    del table
    gc.collect()
    torch.cuda.empty_cache()

    # the first step against the CPU port, in f32 and in bf16
    torch.backends.cuda.matmul.allow_tf32 = False       # f32, as the CPU
    first, cpu_s = {}, 0.0
    for dev in ("cuda", "cpu"):
        p = (state["params"] if dev == "cuda"
             else tree_to(state["params"], "cpu"))
        b = batches[0] if dev == "cuda" else tree_to(batches[0], "cpu")
        for dt in (torch.float32, torch.bfloat16):
            t0 = time.perf_counter()
            first[dev, dt] = first_step(
                partial(recsys.train_loss, cfg, compute_dtype=dt), p, b,
                by_leaf=True)
            cpu_s += (time.perf_counter() - t0) * (dev == "cpu")
            gc.collect()
            torch.cuda.empty_cache()
        del p, b
    f32, bf16 = torch.float32, torch.bfloat16

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, launches, losses = [], [], []
    for s in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        reset_counters(embedding_bag)
        t0 = time.perf_counter()
        state, m = do_step(state, batches[s], s)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches.append(embedding_bag.launches)
        losses.append(m["loss"])
    peak = torch.cuda.max_memory_allocated()
    CARD_S["dcn-v2", "train_batch"] = statistics.median(times[1:])
    require(launches == [1] * TRAIN_STEPS,
            f"recsys_train: embedding_bag launches per step {launches}")
    # f32 is the same arithmetic on both devices: loss and every leaf's
    # gradient within TRAIN_FULL_TOL.  The bf16 step trained above: its
    # loss likewise, its leaves' gradient norms within bf16's rtol of the
    # f32 CPU's (either device's bf16 GEMMs round, and reduce, apart)
    rel = dict(f32=hold_first_step("recsys_train f32", first["cuda", f32],
                                   first["cpu", f32], TRAIN_FULL_TOL),
               bf16_loss=hold_first_step(
                   "recsys_train bf16 loss",
                   {"loss": first["cuda", bf16]["loss"]},
                   {"loss": first["cpu", bf16]["loss"]}, TRAIN_FULL_TOL,
                   losses),
               bf16_leaves=hold_first_step(
                   "recsys_train bf16 gradient against the f32 CPU",
                   {"g": first["cuda", bf16]["leaf_norms_f64"]},
                   {"g": first["cpu", f32]["leaf_norms_f64"]},
                   BF16_GRAD_TOL))
    batch = synthetic_batch(cfg, B, 0, TRAIN_STEPS * 1000, "cuda")
    del batches
    splits = []
    for s in range(3):
        (state, _), parts = split.run(
            lambda: do_step(state, batch, TRAIN_STEPS + s))
        splits.append(parts)
    parts = {k: statistics.median(x[k] for x in splits) for k in splits[0]}
    parts["runs"] = splits
    prof = device_profile(lambda: do_step(state, batch, TRAIN_STEPS + 3))
    emit({"phase": "recsys_train", "arch": cfg.name, "batch": B,
          "steps": TRAIN_STEPS, "init_s": init_s,
          "step_ms_median_2_5": 1e3 * statistics.median(times[1:]),
          "step_ms": [1e3 * t for t in times], "losses": losses,
          "first": {f"{dev}_{str(dt)[6:]}": v
                    for (dev, dt), v in first.items()},
          "rel_err": rel, "tol": TRAIN_FULL_TOL,
          "bf16_grad_tol": BF16_GRAD_TOL, "cpu_first_s": cpu_s,
          "checks": checks, "split_ms": parts,
          "embedding_bag_launches_per_step": launches,
          "peak_mem_bytes": peak, "profiled_step": prof})
    # the backward's scatter-add at the train_batch shape
    gid = (batch["sparse"].long()
           + recsys.table_offsets(cfg, "cuda")).reshape(-1, 1)
    n = gid.shape[0]
    g = torch.randn((n, d), generator=gen, device="cuda").to(torch.bfloat16)
    nbytes = n * (2 * d + 8) + V * d * 2
    bwd = dict(case=f"train_batch, {B} x {cfg.n_sparse} ids (the launcher's"
               f" synthetic ids, < {min(cfg.table_sizes)} per feature), "
               "d 16, bf16 gradient of the bf16 table",
               rows=n, bytes=nbytes,
               ms=cuda_ms(lambda: recsys.embedding_bag_grad(
                   g, gid, None, (V, d), torch.bfloat16), reps=5),
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               library="torch.ops.aten.embedding_dense_backward",
               library_ms=cuda_ms(
                   lambda: torch.ops.aten.embedding_dense_backward(
                       g, gid[:, 0], V, -1, False), reps=5),
               check_train_batch=checks["backward_train_batch"])
    del g, gid
    # held against the plain autograd at the serve_p99 size too
    table = state["params"]["table"].detach().to(torch.bfloat16)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    ids = recsys_ids(cfg, RECSYS_SHAPES["serve_p99"]["batch"],
                     np.random.default_rng(0))
    gid = (ids + recsys.table_offsets(cfg, "cuda")).reshape(-1, 1)
    bwd["check_serve_p99"] = hold_table_grad(
        "embedding_bag backward serve_p99", table, gid, gen)
    emit({"phase": "recsys_train", "backward": bwd})
    del table, gid
    gc.collect()
    torch.cuda.empty_cache()
    return sum(launches), bwd


def phase_roofline() -> dict:
    """The dry run (``repro_torch.launch.dryrun``'s count, on the host:
    rank 0's step on meta tensors under ``roofline.cost``) of the cells
    this run drives uncut on one card, on a ``(1, 1)`` layout: DCN-v2's
    ``ROOFLINE_RECSYS`` calls and step and the four ``GNN_CELLS``.  Each
    cell's roofline terms on the H100 (``roofline.analysis``) beside the
    call or step time phases ``recsys_full``, ``recsys_train`` and
    ``gnn_train`` measured on the card, and the time over the roofline's
    step (how many times the bound).  The serve cells are counted on
    bf16 weights, as ``recsys_full`` serves them (the cells' arguments
    are the reference's f32).  No card work.  Returns the phase's
    readings by cell."""
    import dataclasses

    import torch
    from repro_torch.launch.mesh import layout_mesh
    from repro_torch.launch.specs import build_cell
    from repro_torch.roofline.analysis import analyze
    from repro_torch.roofline.breakdown import breakdown
    from repro_torch.train import pytree
    mesh = layout_mesh((1, 1))
    out = {}
    for arch, shape in [("dcn-v2", s) for s in ROOFLINE_RECSYS] + list(
            GNN_CELLS):
        card_s = CARD_S.get((arch, shape))
        require(card_s is not None, f"roofline: no card time for {arch} x "
                f"{shape}")
        cell = build_cell(arch, shape, mesh)
        if cell.kind != "train":
            params = pytree.tree_map(lambda x: x.to(torch.bfloat16),
                                     cell.args[0])
            cell = dataclasses.replace(cell, args=(params,) + cell.args[1:])
        t0 = time.perf_counter()
        rl, coll, memd, cost = analyze(cell, mesh)
        trace_s = time.perf_counter() - t0
        rec = dict(
            arch=arch, shape=shape, kind=cell.kind, card_s=card_s,
            compute_s=rl.compute_s, memory_s=rl.memory_s,
            collective_s=rl.collective_s, roofline_step_s=rl.step_s,
            bottleneck=rl.bottleneck, card_over_roofline=card_s / rl.step_s,
            flops=rl.flops, flops_by_dtype=cost.flops_by_dtype,
            bytes=rl.bytes_hbm, model_flops=rl.model_flops,
            useful_ratio=rl.useful_ratio, ops=cost.ops, trace_s=trace_s,
            memory=memd, top_ops=[dict(name=n, bytes=b, flops=f, count=c)
                                  for b, f, c, n in breakdown(cost, 3)[0]])
        require(rl.step_s > 0 and all(v >= 0 for v in (
            rl.compute_s, rl.memory_s, rl.collective_s)),
            f"roofline {arch} x {shape}: terms {rl}")
        emit({"phase": "roofline", **rec})
        out[arch, shape] = rec
    return out


def phase_motif_gnn() -> dict:
    """``examples/motif_features_gnn.py`` on the card: the fintxn graph's
    per-node motif features from ``Session.sample_matches`` (M5-3 and
    scatter-gather, delta 2500, K = 2^13, seed 0) equal to the CPU
    port's (``cnt2``, ``phi_v``, ``scale``) and launching both TIMEST
    kernels; then a GraphSAGE classifier (init seed 0) trained for 60
    AdamW steps on ``[log degree || log motif features]``, validation
    accuracy above 0.6 as the example asserts.  Returns the TIMEST
    kernels' launches on the card."""
    import numpy as np
    import torch
    from repro_torch.api import EstimateConfig, Session
    from repro_torch.graphs import fintxn_temporal_graph
    from repro_torch.kernels.interval_weight.ops import dep_sum
    from repro_torch.kernels.tree_sampler.ops import tree_sampler_keyed
    from repro_torch.models import gnn
    from repro_torch.models.convert import init_gnn
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_train_step
    g = fintxn_temporal_graph(**MOTIF_GNN["graph"])
    specs = [(name, MOTIF_GNN["delta"]) for name in MOTIF_GNN["motifs"]]
    out, launches, secs = {}, {}, {}
    for device in ("cpu", "cuda"):
        reset_counters(dep_sum, tree_sampler_keyed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with Session(g, EstimateConfig(device=device)) as s:
            out[device] = s.sample_matches(specs, MOTIF_GNN["K"], seed=0)
        torch.cuda.synchronize()
        secs[device] = time.perf_counter() - t0
        launches[device] = {"interval_weight": dep_sum.launches,
                            "tree_sampler": tree_sampler_keyed.launches}
    require(min(launches["cuda"].values()) > 0
            and max(launches["cpu"].values()) == 0,
            f"motif_gnn: TIMEST kernel launches {launches}")
    for a, b in zip(out["cpu"], out["cuda"], strict=True):
        for k in ("cnt2", "phi_v"):
            require(torch.equal(a[k].cpu(), b[k].cpu()),
                    f"motif_gnn {a['motif'].name}: {k} card != CPU")
        require(a["scale"] == b["scale"], "motif_gnn: scale card != CPU")
    feats_m = np.zeros((g.n, len(specs)), np.float64)
    for j, b in enumerate(out["cuda"]):
        cnt, phi = b["cnt2"].cpu().numpy(), b["phi_v"].cpu().numpy()
        for col in range(phi.shape[1]):
            np.add.at(feats_m[:, j], phi[:, col], cnt * b["scale"])
    mf = np.log1p(feats_m)
    labels = (mf[:, 0] > np.median(mf[:, 0])).astype(np.int32)
    deg = np.zeros((g.n, 2), np.float32)
    np.add.at(deg[:, 0], g.src, 1)
    np.add.at(deg[:, 1], g.dst, 1)
    feats = np.concatenate([np.log1p(deg), mf.astype(np.float32)], axis=1)
    cfg = gnn.GNNConfig(name="sage-aml", kind="sage", n_layers=2,
                        d_hidden=32, aggregator="mean")
    params = init_gnn(cfg, feats.shape[1], 2, seed=0, device="cuda")
    mask = (np.random.default_rng(0).random(g.n) < 0.7).astype(np.float32)
    batch = {k: torch.as_tensor(v).cuda() for k, v in dict(
        feats=feats, senders=g.src.astype(np.int32),
        receivers=g.dst.astype(np.int32), labels=labels,
        train_mask=mask).items()}
    steps = MOTIF_GNN["steps"]
    step = make_train_step(
        lambda p, b: gnn.train_loss(cfg, p, b),
        AdamWConfig(lr=1e-2, total_steps=steps, warmup_steps=5,
                    weight_decay=0.0))
    opt = adamw_init(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for i in range(steps):
        params, opt, m = step(params, opt, batch)
        if i % 15 == 0 or i == steps - 1:
            losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    with torch.no_grad():
        pred = gnn.forward(cfg, params, batch).argmax(-1).cpu().numpy()
    val = mask == 0
    acc = float((pred[val] == labels[val]).mean())
    require(acc > MOTIF_GNN["acc_min"],
            f"motif_gnn: validation accuracy {acc}")
    emit({"phase": "motif_gnn", "graph_n": g.n, "graph_m": g.m,
          "motifs": list(MOTIF_GNN["motifs"]), "K": MOTIF_GNN["K"],
          "features_equal": True, "sample_matches_s": secs,
          "launches_card": launches["cuda"], "train_steps": steps,
          "train_s": train_s, "losses": losses, "val_accuracy": acc,
          "acc_min": MOTIF_GNN["acc_min"]})
    return launches["cuda"]


@contextlib.contextmanager
def deterministic():
    """Inside the ``with``, torch's deterministic algorithms (warnings
    only where an op has none, and those silenced): the card's
    scatter-adds then sum in one order, so two runs of the same steps
    are equal bit for bit."""
    import warnings

    import torch
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)


def phase_lm_train_small() -> dict:
    """Card against CPU for the five LM smoke configs on the same numpy
    tree and batches (``repro_torch.testing.lm_train_runs``): the first
    loss and every gradient leaf, then three AdamW steps (losses and
    every parameter leaf), within ``LM_TRAIN_TOL`` in f32 (no TF32) and
    bf16 (an MoE config's routes pinned to the CPU's); each step must
    launch the flash kernel twice a layer (forward and remat recompute)
    and the grouped GEMM nine times a MoE layer.  Then granite-moe smoke
    through ``launch.train``'s ``build`` and ``run_resumable``, killed
    after step 2 and resumed, equal to the straight run bit for bit
    (``deterministic``).  Returns each kernel's launches."""
    import shutil

    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.segment_matmul.ops import segment_matmul
    from repro_torch.launch.train import build, synthetic_batch
    from repro_torch.testing import compare_lm_train, lm_train_runs
    from repro_torch.train import pytree
    from repro_torch.train.fault_tolerance import run_resumable
    reset_counters(flash_attention, segment_matmul)
    for arch in LM_IDS:
        cfg = get_smoke_config(arch)
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype).split(".")[1]
            runs, flips = lm_train_runs(arch, dtype, device="cuda")
            want = dict(flash_attention=2 * cfg.n_layers,
                        segment_matmul=9 * cfg.n_layers * cfg.is_moe,
                        embedding_bag=0)
            require(runs[1]["launches"] == want,
                    f"lm_train_small {arch} {dt}: launches per step "
                    f"{runs[1]['launches']}, not {want}")
            err = compare_lm_train(runs, LM_TRAIN_TOL[dt])
            emit({"phase": "lm_train_small", "arch": cfg.name, "dtype": dt,
                  "tol": LM_TRAIN_TOL[dt], "rel_err": err,
                  "route_flips": flips, "losses_card": runs[1]["losses"],
                  "losses_cpu": runs[0]["losses"],
                  "launches_per_step": runs[1]["launches"]})
    launches = dict(flash=by_kernel(flash_attention),
                    segment_matmul=by_kernel(segment_matmul))
    cfg = get_smoke_config("granite-moe-3b-a800m")
    root = ROOT / "build" / "chip_smoke_lm_train"
    shutil.rmtree(root, ignore_errors=True)

    def batches(step, attempt):
        return synthetic_batch(cfg, 2, 16, step * 1000 + attempt, "cuda")
    final = {}
    with deterministic():
        for run, stops in (("straight", (4,)), ("killed", (2, 4))):
            for total in stops:
                state, do_step = build(cfg, 1e-3, 4, device="cuda")
                state, rep = run_resumable(do_step, state, batches, total,
                                           str(root / run), ckpt_every=1)
            final[run] = (pytree.leaves(state), rep)
    (a, rep_a), (b, rep_b) = final["straight"], final["killed"]
    require(rep_b.resumed_from == 2 and rep_b.steps_run == 2
            and rep_a.steps_run == 4,
            f"lm_train_small resume: {rep_a}, {rep_b}")
    require(all(torch.equal(x, y) for x, y in zip(a, b, strict=True)),
            "lm_train_small: the resumed run differs from the straight run")
    shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "lm_train_small", "case": f"{cfg.name} run_resumable",
          "killed_after": 2, "steps": 4, "resumed_from": rep_b.resumed_from,
          "equal": True, "leaves": len(a), "launches": launches})
    return launches


def lm100m():
    """``examples/train_lm.py``'s ``lm100m()``: 12 layers, d 768, 12
    heads over 4 kv heads, d_ff 2048, vocab 8192."""
    from repro_torch.models.transformer import LMConfig
    return LMConfig(name="lm100m", n_layers=12, d_model=768, n_heads=12,
                    n_kv_heads=4, d_ff=2048, vocab=8_192)


def markov_batch(cfg, B: int, S: int, step: int, attempt: int = 0) -> dict:
    """``examples/train_lm.py``'s ``batch_fn`` (numpy seed ``1000 * step
    + attempt``): Markov-chain tokens that jump to a random token with
    probability 0.1 and otherwise step ``state * 31 + 7``; on the
    card."""
    import numpy as np
    import torch
    r = np.random.default_rng(1000 * step + attempt)
    state = r.integers(0, cfg.vocab, size=B)
    toks = np.empty((B, S + 1), np.int64)
    for t in range(S + 1):
        toks[:, t] = state
        jump = r.random(B) < 0.1
        state = np.where(jump, r.integers(0, cfg.vocab, size=B),
                         (state * 31 + 7) % cfg.vocab)
    return dict(tokens=torch.as_tensor(toks[:, :-1], dtype=torch.int32,
                                       device="cuda"),
                labels=torch.as_tensor(toks[:, 1:], dtype=torch.int32,
                                       device="cuda"),
                mask=torch.ones((B, S), dtype=torch.float32, device="cuda"))


def phase_lm_train_learn() -> dict:
    """``examples/train_lm.py`` on the card: lm100m from
    ``init_lm_params`` seed 0 (f32, bf16 compute, remat), AdamW at lr
    6e-4 with warmup 20 over ``LEARN["steps"]`` steps (the example's 200
    cut to 60 for the run's time, printed as ``reduced``), batch 8 x 128
    in two microbatches, ``run_resumable`` with a checkpoint every
    ``LEARN["resume_at"]`` steps; the loss must fall (mean of the last 20
    below the first 20, and the last below the first, as the example
    asserts).  Then a run that lost everything after that checkpoint
    (the checkpoint alone, resumed) must end within ``LEARN_RESUME_TOL``
    of the straight run.  Returns the kernel launches of the straight
    run."""
    import shutil
    import statistics
    from functools import partial

    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.segment_matmul.ops import segment_matmul
    from repro_torch.models import transformer
    from repro_torch.models.convert import init_lm_params
    from repro_torch.train import pytree
    from repro_torch.train.fault_tolerance import run_resumable
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_train_step
    cfg = lm100m()
    st = LEARN
    step_fn = make_train_step(
        partial(transformer.train_loss, cfg),
        AdamWConfig(lr=st["lr"], total_steps=st["steps"],
                    warmup_steps=st["warmup"]), accum_steps=st["accum"])
    times = []

    def do_step(state, batch, step):
        t0 = time.perf_counter()
        p, o, m = step_fn(state["params"], state["opt"], batch)
        m = {k: float(v) for k, v in m.items()}         # waits for the card
        times.append(time.perf_counter() - t0)
        return dict(params=p, opt=o), m

    def fresh():
        params = init_lm_params(cfg, seed=0, device="cuda")
        return dict(params=params, opt=adamw_init(params))

    def batches(step, attempt):
        return markov_batch(cfg, st["batch"], st["seq"], step, attempt)
    root = ROOT / "build" / "chip_smoke_lm100m"
    shutil.rmtree(root, ignore_errors=True)
    state = fresh()
    n_params = sum(x.numel() for x in pytree.leaves(state["params"]))
    reset_counters(flash_attention, segment_matmul)
    t0 = time.perf_counter()
    state, rep = run_resumable(do_step, state, batches, st["steps"],
                               str(root / "straight"),
                               ckpt_every=st["resume_at"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(flash=by_kernel(flash_attention),
                    segment_matmul=by_kernel(segment_matmul))
    step_times = times[:]
    losses = [m["loss"] for m in rep.metrics]
    k = st["resume_at"]
    ckpt_name = f"step_{k:08d}"
    shutil.copytree(root / "straight" / ckpt_name, root / "killed" / ckpt_name)
    resumed, rep2 = run_resumable(do_step, fresh(), batches, st["steps"],
                                  str(root / "killed"), ckpt_every=k)
    losses2 = [m["loss"] for m in rep2.metrics]
    a, b = pytree.leaves(state), pytree.leaves(resumed)
    leaf_rel = [float((y.double() - x.double()).norm()
                      / x.double().norm().clamp(min=1e-30))
                for x, y in zip(a, b, strict=True)
                if torch.is_floating_point(x)]
    loss_rel = [abs(y - x) / abs(x) for x, y in zip(losses[k:], losses2)]
    equal = all(torch.equal(x, y) for x, y in zip(a, b))
    shutil.rmtree(root, ignore_errors=True)
    first, last = (statistics.fmean(losses[:20]),
                   statistics.fmean(losses[-20:]))
    require(rep.steps_run == st["steps"] and rep2.resumed_from == k
            and rep2.steps_run == st["steps"] - k,
            f"lm_train_learn: runs {rep}, {rep2}")
    require(all(map(torch.isfinite, map(torch.as_tensor, losses)))
            and last < first and losses[-1] < losses[0],
            f"lm_train_learn: the loss did not fall ({first} -> {last})")
    require(max(loss_rel) <= LEARN_RESUME_TOL
            and max(leaf_rel) <= LEARN_RESUME_TOL,
            f"lm_train_learn: resumed run off the straight one: losses "
            f"{max(loss_rel)}, leaves {max(leaf_rel)}")
    per_step = st["steps"]
    want = 2 * cfg.n_layers * st["accum"] * per_step
    require(launches["flash"] == dict(sm90=want, simt=0)
            and launches["segment_matmul"] == dict(sm90=0, simt=0),
            f"lm_train_learn: launches {launches}, not {want} sm90 flash")
    emit({"phase": "lm_train_learn", "arch": cfg.name, "params": n_params,
          **{key: st[key] for key in ("batch", "seq", "accum", "lr",
                                      "warmup", "steps")},
          "reduced": {"steps": [st["steps"], 200, "the run's time limit"],
                      "resume_at": [st["resume_at"], 100,
                                    "the run's time limit"]},
          "loss_first": losses[0], "loss_last": losses[-1],
          "loss_mean_first_20": first, "loss_mean_last_20": last,
          "losses_every_20": losses[::20], "wall_s": wall,
          "step_ms_median": 1e3 * statistics.median(step_times[1:]),
          "resumed_from": rep2.resumed_from, "resume_tol": LEARN_RESUME_TOL,
          "resume_max_loss_rel": max(loss_rel),
          "resume_max_leaf_rel_l2": max(leaf_rel),
          "resume_bit_equal": equal,
          "flash_sm90_launches_per_step": launches["flash"]["sm90"]
          / per_step})
    del state, resumed, a, b
    return launches


def granite_train_cut(n_layers: int):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(FULL_TRAIN["arch"]),
                               n_layers=n_layers)


def free_card() -> None:
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def lm_train_kernel_cases(cfg, heads=None, experts=None,
                          width=None) -> dict:
    """The two kernels at the shapes this path gives them, bf16 on the
    card: the sm90 flash kernel on one layer's causal global attention
    (1 x 4096 tokens, 24 query heads over 8 kv heads, D 64: G = 3; or
    ``heads = (q, kv)``, one rank's) against
    ``flash_attention_ref(round_p=True)``, timed beside its bound,
    the plain version and SDPA, which computes the same function here (no
    softcap, no window); and the sm90 grouped GEMM on the gate/up product
    (48 experts x C rows, K 1536, N 512, C the capacity of one sequence;
    or ``experts`` of them, ``width`` rows each: a rank's table) and on
    the down product (K 512, N 1536: also
    the shape of gate/up's dX), against ``segment_matmul_ref``, beside
    ``torch.bmm``.  Then the attention's backward (``FlashAttentionFn``:
    ``attention_blockwise`` per q block) and the grouped GEMM's (dX
    kernel, dW ``bmm`` + ``index_add_``), timed at the same shapes, for
    the step's breakdown."""
    import torch
    from repro_torch.kernels.flash_attention.ops import (attended_pairs,
                                                         flash_attention)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.segment_matmul.ops import segment_matmul
    from repro_torch.kernels.segment_matmul.ref import segment_matmul_ref
    from repro_torch.models.attention import FlashAttentionFn
    from repro_torch.models.moe import SegmentMatmulFn, capacity
    from repro_torch.testing import p_rounding_allowance
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1)
    S, D = FULL_TRAIN["seq"], cfg.hd
    Hq, Hkv = heads or (cfg.n_heads, cfg.n_kv_heads)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(bf16)
                  for shape in ((1, S, Hq, D), (1, S, Hkv, D),
                                (1, S, Hkv, D), (1, S, Hq, D)))
    kw = dict(causal=True, window=0, attn_softcap=cfg.attn_softcap)
    n90 = flash_attention.launches_sm90
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, round_p=True, **kw)
    torch.cuda.synchronize()
    require(flash_attention.launches_sm90 == n90 + 1,
            "lm_train flash: not through the sm90 kernel")
    err = (got.float() - want.float()).abs()
    allow = p_rounding_allowance(q, k, v, **kw)
    ok = bool((err <= FA_ATOL + FA_RTOL * want.float().abs() + allow).all())
    fa = dict(case=f"1 x {S}, {Hq} / {Hkv} heads, D {D}, causal global",
              max_abs_err=float(err.max()), rel_l2=rel_l2(got, want))
    require(bool(torch.isfinite(got).all()) and ok
            and fa["rel_l2"] <= FA_REL_L2,
            f"lm_train flash against its plain version: {fa}")
    del got, want, err, allow
    pairs = attended_pairs(S, S, True, 0) * Hq
    flops, nbytes = 4 * D * pairs, 2 * (2 * q.numel() + 2 * k.numel())
    lib_ms, lib_gqa = sdpa_ms(q, k, v)
    fa.update(
        ms=cuda_ms(lambda: flash_attention(q, k, v, **kw), reps=20),
        plain_ms=cuda_ms(lambda: flash_attention_ref(q, k, v, round_p=True,
                                                     **kw), reps=1),
        bound_ms=max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
        * 1e3,
        bound_by=("operations" if flops / BF16_FLOPS_PER_S
                  >= nbytes / HBM_BYTES_PER_S else "bytes"),
        sfu_bound_ms=sfu_bound_ms(pairs, cfg.attn_softcap),
        library_ms=lib_ms, library="scaled_dot_product_attention",
        library_gqa=lib_gqa)
    x = [t.detach().requires_grad_() for t in (q, k, v)]
    out = FlashAttentionFn.apply(*x, True, 0, cfg.attn_softcap)

    def backward():
        return torch.autograd.grad(out, x, g, retain_graph=True)
    fa["backward_ms"] = cuda_ms(backward, reps=3)
    prof = device_profile(backward)
    fa.update(backward_device_ms=1e3 * prof["device_busy_s"],
              backward_kernels=prof["kernel_launches"])
    del q, k, v, g, x, out
    free_card()

    E, d, ffe = experts or cfg.e_pad, cfg.d_model, cfg.d_expert
    C = width or capacity(cfg, S)
    groups = torch.arange(E, dtype=torch.int32, device="cuda")
    cases = {}
    for case, K, N in (("gate/up", d, ffe), ("down; gate/up dX", ffe, d)):
        x = torch.randn((E * C, K), generator=gen, device="cuda").to(bf16)
        w = (torch.randn((E, K, N), generator=gen, device="cuda")
             * K ** -0.5).to(bf16)
        n = segment_matmul.launches_sm90
        got = segment_matmul(x, w, groups)
        want = segment_matmul_ref(x, w, groups)
        torch.cuda.synchronize()
        require(segment_matmul.launches_sm90 == n + 1,
                f"lm_train segment_matmul {case}: not the sm90 kernel")
        rec = dict(case=f"{case}: {E} x {C} rows, K {K}, N {N}",
                   **check_close(f"lm_train segment_matmul {case}", got,
                                 want, "bfloat16"))
        del got, want
        flops = 2 * E * C * K * N
        nbytes = (E * C * K + E * K * N + E * C * N) * 2
        rec.update(
            ms=cuda_ms(lambda: segment_matmul(x, w, groups), reps=20),
            plain_ms=cuda_ms(lambda: segment_matmul_ref(x, w, groups),
                             reps=3),
            library_ms=cuda_ms(lambda: torch.bmm(x.view(E, C, K), w),
                               reps=20),
            bound_ms=max(flops / BF16_FLOPS_PER_S,
                         nbytes / HBM_BYTES_PER_S) * 1e3,
            bound_by=("operations" if flops / BF16_FLOPS_PER_S
                      >= nbytes / HBM_BYTES_PER_S else "bytes"))
        a, b = x.requires_grad_(), w.requires_grad_()
        y = SegmentMatmulFn.apply(a, b, groups)
        dy = torch.randn(y.shape, generator=gen, device="cuda").to(bf16)
        rec["backward_ms"] = cuda_ms(lambda: torch.autograd.grad(
            y, (a, b), dy, retain_graph=True), reps=5)
        cases[case] = rec
        del x, w, a, b, y, dy
        free_card()
    return dict(flash=fa, segment_matmul=cases)


def train_probe(L: int, batch) -> tuple:
    """One bf16 training step of the cut at ``L`` layers from fresh
    state: ``(peak bytes allocated, the initial state)``."""
    import torch
    from repro_torch.launch.train import build
    state, do_step = build(granite_train_cut(L), 3e-4, 2,
                           accum=FULL_TRAIN["accum"], device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    new, _ = do_step(state, batch, 0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del new
    return peak, state


def phase_lm_train_full() -> dict:
    """granite-moe-3b-a800m trained at full width on one card: f32
    parameters and AdamW state, bf16 compute, remat per layer, the
    ``launch.train`` step (``build``) on ``synthetic_batch`` traffic of
    train_4k sequences, one per microbatch, accumulation 4.

    1. Depth (a cut for memory): one step each at 2 and 4 layers gives
       the peak's intercept and its slope per layer; the depth is the
       deepest even one whose predicted peak stays ``FULL_TRAIN_MARGIN``
       below the card's memory (a step that still runs out of memory
       drops it by 2, recorded).
    2. The f32 check on the 2-layer cut: one 4096-token sequence in f32
       compute on the card and on the CPU, the loss and each leaf's
       gradient norm (f64) within ``TRAIN_FULL_TOL``, through the
       CUDA-core kernels of both.
    3. ``FULL_TRAIN["steps"]`` steps at the chosen depth: step ms
       (median of the steps after the first, synced), the forward /
       backward / optimizer
       split (``StepSplit``), tokens/s, peak memory, MFU (``6 *
       active_param_count * tokens / step_s`` over 989 TFLOP/s bf16, the
       reference's ``model_flops``), launches per step, which must be
       the sm90 flash kernel 2 per layer-microbatch (forward, remat) and
       the sm90 grouped GEMM 9 (three products, recomputed, three dX),
       and none of the CUDA-core kernels; then one profiled step (idle
       share).
    4. The kernels at this path's shapes (``lm_train_kernel_cases``).
    Returns the launches and the kernel readings."""
    import statistics
    from functools import partial

    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.segment_matmul.ops import segment_matmul
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build, synthetic_batch
    from repro_torch.models import transformer
    from repro_torch.train import pytree
    ft = FULL_TRAIN
    torch.backends.cuda.matmul.allow_tf32 = False
    free_card()
    total = torch.cuda.get_device_properties(0).total_memory
    seq, accum, steps = ft["seq"], ft["accum"], ft["steps"]
    cfg = granite_train_cut(ft["check_layers"])
    batch = synthetic_batch(cfg, accum, seq, 0, "cuda")
    t0 = time.perf_counter()
    probes = {}
    for L in (2, 4):
        probes[L], state = train_probe(L, batch)
        if L == ft["check_layers"]:
            # the f32 check on this cut's initial weights
            one = {k: v[:1] for k, v in batch.items()}
            loss_fn = partial(transformer.train_loss, cfg,
                              compute_dtype=torch.float32)
            reset_counters(flash_attention, segment_matmul)
            card = first_step(loss_fn, state["params"], one, by_leaf=True)
            check_launches = dict(flash=by_kernel(flash_attention),
                                  segment_matmul=by_kernel(segment_matmul))
            t1 = time.perf_counter()
            cpu = first_step(loss_fn, tree_to(state["params"], "cpu"),
                             tree_to(one, "cpu"), by_leaf=True)
            cpu_s = time.perf_counter() - t1
            rel = hold_first_step("lm_train_full f32 check", card, cpu,
                                  TRAIN_FULL_TOL)
            require(check_launches["flash"]["simt"] == 2 * L
                    and check_launches["segment_matmul"]["simt"] == 9 * L
                    and check_launches["flash"]["sm90"] == 0
                    and check_launches["segment_matmul"]["sm90"] == 0,
                    f"lm_train_full f32 check launches {check_launches}")
            emit({"phase": "lm_train_full", "check": f"{L}-layer cut, 1 x "
                  f"{seq} tokens, f32 compute, card against CPU",
                  "loss_card": card["loss"], "loss_cpu": cpu["loss"],
                  "grad_norm_f64_card": card["grad_norm_f64"],
                  "grad_norm_f64_cpu": cpu["grad_norm_f64"],
                  "max_rel_err": max(rel.values()), "tol": TRAIN_FULL_TOL,
                  "cpu_s": cpu_s, "launches": check_launches})
        del state
        free_card()
    per_layer = (probes[4] - probes[2]) / 2
    base = probes[2] - 2 * per_layer
    budget = total * (1 - FULL_TRAIN_MARGIN)
    full_depth = get_config(ft["arch"]).n_layers
    depth = max(L for L in range(2, full_depth + 1, 2)
                if L == 2 or base + per_layer * L <= budget)
    probe_s = time.perf_counter() - t0
    split = StepSplit()
    oom_at = []
    t_steps = time.perf_counter()
    while True:
        cfg = granite_train_cut(depth)
        t0 = time.perf_counter()
        state, do_step = build(cfg, 3e-4, steps + 1, accum=accum,
                               device="cuda", mark=split)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        batches = [synthetic_batch(cfg, accum, seq, s * 1000, "cuda")
                   for s in range(steps + 1)]
        reset_counters(flash_attention, segment_matmul)
        times, parts, losses, launches = [], [], [], []
        try:
            for s in range(steps):
                n = (flash_attention.launches_sm90,
                     segment_matmul.launches_sm90)
                t0 = time.perf_counter()
                (state, m), part = split.run(
                    lambda: do_step(state, batches[s], s))
                times.append(time.perf_counter() - t0)
                parts.append(part)
                losses.append(m["loss"])
                launches.append((flash_attention.launches_sm90 - n[0],
                                 segment_matmul.launches_sm90 - n[1]))
        except torch.cuda.OutOfMemoryError:
            require(depth > 2, "lm_train_full: 2 layers do not fit")
            oom_at.append(depth)
        else:
            break
        # outside the handler: its traceback holds the step's tensors
        del state, do_step, batches
        free_card()
        depth -= 2
    run_launches = dict(flash=by_kernel(flash_attention),
                        segment_matmul=by_kernel(segment_matmul))
    want = (2 * depth * accum, 9 * depth * accum)
    require(all(x == want for x in launches)
            and run_launches["flash"]["simt"] == 0
            and run_launches["segment_matmul"]["simt"] == 0,
            f"lm_train_full: launches per step (flash sm90, segment_matmul "
            f"sm90) {launches}, not {want}; by kernel {run_launches}")
    require(all(map(torch.isfinite, map(torch.as_tensor, losses))),
            f"lm_train_full: losses {losses}")
    step_s = statistics.median(times[1:])
    split_ms = {k: statistics.median(p[k] for p in parts[1:])
                for k in parts[0] if k.endswith("_ms")}
    peak = max(v for p in parts for k, v in p.items()
               if k.endswith("_peak_bytes"))
    steps_s = time.perf_counter() - t_steps
    t0 = time.perf_counter()
    prof = device_profile(
        lambda: do_step(state, batches[steps], steps),
        {"flash_attention_sm90": lambda k: "flash" in k.lower(),
         "segment_matmul_sm90": lambda k: "segment" in k.lower(),
         "gemm": lambda k: any(w in k.lower() for w in
                               ("gemm", "cutlass", "xmma", "nvjet",
                                "cublas"))})
    tokens = accum * seq
    active = cfg.active_param_count()
    n_params = sum(x.numel() for x in pytree.leaves(state["params"]))
    del state, do_step, batches
    free_card()
    profile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernels = lm_train_kernel_cases(cfg)
    kernels_s = time.perf_counter() - t0
    # the attention backward's device time (its wall, host-bound when
    # run alone, hides behind the step's longer kernels)
    attn_share = (kernels["flash"]["backward_device_ms"] * depth * accum
                  / (1e3 * step_s))
    emit({"phase": "lm_train_full", "arch": cfg.name,
          "cuts": {"n_layers": [depth, full_depth, "memory: the deepest "
                                "even depth "
                                "whose step peak fits one card (probed "
                                "at 2 and 4 layers)"],
                   "batch": [f"{accum} x {seq} tokens a step", "train_4k: "
                             "256 x 4096", "the run's time limit"]},
          "reduced": {"steps": [steps, 5, "the run's time limit"]},
          "probe_peak_bytes": probes, "per_layer_bytes": per_layer,
          "base_bytes": base, "budget_bytes": budget, "total_bytes": total,
          "probe_s": probe_s, "steps_s": steps_s, "profile_s": profile_s,
          "kernels_s": kernels_s, "oom_at": oom_at, "init_s": init_s,
          "params": n_params, "active_params": active, "steps": steps,
          "step_ms": [1e3 * t for t in times],
          "step_ms_after_first": 1e3 * step_s, "split_ms": split_ms,
          "tokens_per_s": tokens / step_s, "peak_mem_bytes": peak,
          "mfu": 6 * active * tokens / step_s / BF16_FLOPS_PER_S,
          "losses": losses, "launches_per_step": {
              "flash_attention_sm90": launches[0][0],
              "segment_matmul_sm90": launches[0][1]},
          "attention_backward_share": attn_share,
          "profiled_step": prof, "kernels": kernels})
    return dict(depth=depth, launches=run_launches, kernels=kernels,
                check_launches=check_launches)


class CollectiveClock:
    """Host seconds spent inside the port's collectives
    (``dist.collectives``' ``all_gather_dim``, ``reduce_scatter_dim``
    and ``all_reduce``, through which every collective of the model mesh
    goes), the card synced before and after each: installed over the
    module's functions for the life of a rank."""

    def __init__(self):
        from repro_torch.dist import collectives
        self.seconds, self.calls = 0.0, 0
        for name in ("all_gather_dim", "reduce_scatter_dim", "all_reduce"):
            setattr(collectives, name, self.timed(getattr(collectives,
                                                          name)))

    def timed(self, fn):
        import torch

        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out
        return run


def dist_cut(n_layers: int, mesh=None):
    """``granite_train_cut``, sequence parallel over ``mesh``'s model
    axis when a mesh is given (the reference's ``residual_spec``)."""
    import dataclasses

    from repro_torch.dist.sharding import data_axes
    cfg = granite_train_cut(n_layers)
    if mesh is None:
        return cfg
    return dataclasses.replace(cfg, residual_spec=(data_axes(mesh), "model",
                                                   None))


def leaf_norms_f64(grads, mesh=None, specs=None) -> dict:
    """Each leaf's f64 norm by its path; on a mesh the leaves are pieces
    under ``specs`` and their squares are summed over the axes that
    shard them (a collective: every rank calls it)."""
    import torch
    from repro_torch.dist.collectives import all_reduce
    from repro_torch.train import pytree
    out = {}
    spec_of = (pytree.leaves(specs) if specs is not None
               else [()] * len(pytree.leaves(grads)))
    for (path, g), spec in zip(pytree.flatten_with_paths(grads), spec_of,
                               strict=True):
        sq = torch.zeros((), dtype=torch.float64, device=g.device)
        for part in g.reshape(-1).split(1 << 24):
            sq += part.double().square().sum()
        for axes in spec:
            if axes is not None:
                sq = all_reduce(sq, mesh.group(axes))
        out[path] = float(sq) ** 0.5
    return out


def one_process_routes(mesh, fn):
    """``fn()`` on rank 0 alone, its MoE routes recorded
    (``testing.MeshRoutes``), while the other ranks wait; every rank
    gets ``(fn's result on rank 0, the routes)``."""
    import torch.distributed as dist
    from repro_torch.testing import MeshRoutes
    box = [None]
    if mesh.rank == 0:
        with MeshRoutes().record() as rec:
            out = fn()
        box = [(out, rec.calls)]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def dist_f32_check(mesh, seq: int) -> dict:
    """The 2-layer cut in f32 compute on ``mesh`` (one sequence per data
    rank, from ``synthetic_batch``) against one process on rank 0's card:
    the loss and every gathered gradient leaf, relative L2.  The mesh
    routes its MoE layers as the one process did (``MeshRoutes``): their
    partial sums add in another order, and where a token's experts sit
    at a near tie its choice, and with the capacity the slots of the
    tokens after it, would follow that order (on the H100, unpinned:
    4.7e-3 in every leaf at 4096 tokens a sequence, 4e-6 at 256, where
    the routes agreed).  Every rank calls it; rank 0 returns the
    errors."""
    from functools import partial

    import torch
    from repro_torch.dist.sharding import n_data, unshard
    from repro_torch.launch.train import state_specs, synthetic_batch
    from repro_torch.models import transformer
    from repro_torch.models.convert import init_lm_params
    from repro_torch.testing import MeshRoutes
    from repro_torch.train import pytree
    from repro_torch.train.steps import (data_share, sum_over_data,
                                         value_and_grad)
    L = DIST_TRAIN["check_layers"]
    cfg = dist_cut(L, mesh if mesh.extent("model") > 1 else None)
    one = granite_train_cut(L)
    batch = synthetic_batch(cfg, n_data(mesh), seq, 7, mesh.device)

    def reference():
        loss, grads = value_and_grad(partial(
            transformer.train_loss, one, compute_dtype=torch.float32))(
            init_lm_params(one, seed=0, device=mesh.device), batch)
        return float(loss), pytree.flatten_with_paths(grads)
    (ref_loss, ref), calls = one_process_routes(mesh, reference)
    specs = state_specs(cfg, mesh)["params"]
    params = init_lm_params(cfg, seed=0, mesh=mesh)
    with MeshRoutes(calls).pin(mesh.coord(("data",))) as pinned:
        loss, grads = value_and_grad(partial(
            transformer.train_loss, cfg, compute_dtype=torch.float32,
            mesh=mesh))(params, {k: data_share(v, mesh)
                                 for k, v in batch.items()})
    grads = sum_over_data(grads, mesh, specs)
    full = [unshard(g, sp, mesh) for g, sp in
            zip(pytree.leaves(grads), pytree.leaves(specs), strict=True)]
    del params, grads
    if mesh.rank != 0:
        return {}
    errs = {p: float((a - b).norm() / b.norm().clamp(min=1e-30))
            for (p, b), a in zip(ref, full, strict=True)}
    return dict(loss=float(loss), loss_one_process=ref_loss,
                loss_rel_err=abs(float(loss) - ref_loss) / abs(ref_loss),
                max_rel_l2=max(errs.values()), rel_l2=errs,
                route_flips=pinned.flips)


def progress(rank: int, text: str, phase: str = "lm_train_dist") -> None:
    """Rank 0's progress through a phase on the mesh, on stderr."""
    if rank == 0:
        print(f"{phase} rank 0: {text}", file=sys.stderr, flush=True)


def dist_rank_mesh(rank: int, world_size: int, init_method: str, data: int,
                   model: int, pod: int = 0, backend: str = "gloo"):
    """This rank's ``make_host_mesh`` on the card (gloo where ranks share
    it: NCCL refuses two ranks on one card), f32 products without TF32,
    the allocator's segments expandable (four processes share the
    card)."""
    import warnings

    import torch
    from repro_torch.launch.mesh import make_host_mesh
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    torch.backends.cuda.matmul.allow_tf32 = False
    return make_host_mesh(data, model, pod, rank=rank,
                          world_size=world_size, init_method=init_method,
                          backend=backend, device="cuda")


def dist_train_rank(rank: int, world_size: int, init_method: str,
                    backend: str) -> dict:
    """One rank of phase ``lm_train_dist``: the training steps and the
    f32 check (``phase_lm_train_dist``)."""
    import statistics

    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.segment_matmul.ops import segment_matmul
    from repro_torch.launch.train import build, state_specs, synthetic_batch
    from repro_torch.models.moe import capacity
    from repro_torch.testing import MeshRoutes
    from repro_torch.train import pytree
    from repro_torch.train import steps as steps_mod
    dt = DIST_TRAIN
    data, model = dt["dims"]
    mesh = dist_rank_mesh(rank, world_size, init_method, data, model,
                          backend=backend)
    clock = CollectiveClock()
    seq, accum, steps, depth = (dt["seq"], dt["accum"], dt["steps"],
                                dt["depth"])
    B = accum * data
    total = torch.cuda.get_device_properties(mesh.device).total_memory

    # step 1 of the same cut, batch and weights in one process (rank 0's
    # card), its routes recorded for the mesh's step 1
    t0 = time.perf_counter()
    batches = [synthetic_batch(dist_cut(depth, mesh), B, seq, s * 1000,
                               mesh.device) for s in range(steps)]
    one, calls = one_process_routes(
        mesh, lambda: one_process_first_step(depth, batches[0]))
    free_card()
    one_s = time.perf_counter() - t0
    progress(rank, f"one process, step 1: loss {one['loss']:.5f} "
             f"({one_s:.1f} s)")

    cfg = dist_cut(depth, mesh)
    split = StepSplit()
    t0 = time.perf_counter()
    state, do_step = build(cfg, 3e-4, steps + 1, accum=accum, mark=split,
                           mesh=mesh, zero=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    specs = state_specs(cfg, mesh, zero=True)
    state_bytes = sum(x.numel() * x.element_size() for x in
                      pytree.leaves(state["params"])
                      + pytree.leaves(state["opt"]))
    captured = {}
    own_update = steps_mod.adamw_update

    def capture(opt_cfg, grads, opt_state, params, **kw):
        # step 1's gradient as the optimizer receives it (summed over
        # the data axes, ZeRO slices, divided by the accumulation)
        if not captured:
            captured["leaf_norms_f64"] = leaf_norms_f64(
                grads, mesh, kw["state_specs"].mu)
        return own_update(opt_cfg, grads, opt_state, params, **kw)
    steps_mod.adamw_update = capture
    reset_counters(flash_attention, segment_matmul)
    times, parts, losses, launches, coll_s, peaks = [], [], [], [], [], []
    pinned = MeshRoutes(calls)
    slots = CountDrops().__enter__()
    for s in range(steps):
        n = (flash_attention.launches_sm90, segment_matmul.launches_sm90)
        c0 = clock.seconds
        t1 = time.perf_counter()
        # step 1 routes as the one process did (its near ties), the
        # other steps their own
        with (pinned.pin(mesh.coord(("data",))) if s == 0
              else contextlib.nullcontext()):
            (state, m), part = split.run(
                lambda: do_step(state, batches[s], s))
        times.append(time.perf_counter() - t1)
        coll_s.append(clock.seconds - c0)
        parts.append(part)
        losses.append(m["loss"])
        launches.append((flash_attention.launches_sm90 - n[0],
                         segment_matmul.launches_sm90 - n[1]))
        peaks.append(max(v for k, v in part.items()
                         if k.endswith("_peak_bytes")))
        progress(rank, f"step {s + 1}: {times[-1]:.2f} s, collectives "
                 f"{coll_s[-1]:.2f} s, loss {losses[-1]:.5f}")
    steps_mod.adamw_update = own_update
    slots.__exit__()
    run_launches = dict(flash=by_kernel(flash_attention),
                        segment_matmul=by_kernel(segment_matmul))
    del state, do_step, batches
    free_card()
    t0 = time.perf_counter()
    check = dist_f32_check(mesh, seq)
    check_s = time.perf_counter() - t0
    step_s = statistics.median(times[1:])
    return dict(
        rank=rank, coords=mesh.coords, depth=depth,
        one_process=dict(one, seconds=one_s), route_flips=pinned.flips,
        total_bytes=total, init_s=init_s,
        step_ms=[1e3 * t for t in times], step_s=step_s,
        collective_ms=[1e3 * c for c in coll_s],
        split_ms={k: statistics.median(p[k] for p in parts[1:])
                  for k in parts[0] if k.endswith("_ms")},
        losses=losses, launches_per_step=launches,
        launches=run_launches, peak_bytes=max(peaks),
        state_bytes=state_bytes, check=check, check_s=check_s,
        first_step=dict(loss=losses[0], **captured),
        slot_fill=dict(fill=int(slots.filled) / slots.rows,
                       fill_at_global_capacity=(int(slots.filled)
                                                / slots.rows_at_capacity),
                       width_median=statistics.median(slots.widths),
                       width_max=max(slots.widths),
                       capacity=capacity(cfg, data * seq)))


def dist_nccl_rank(rank: int, world_size: int, init_method: str,
                   dims) -> dict:
    """The f32 check of ``dist_f32_check`` on a mesh over NCCL, one rank
    per card."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_host_mesh(*dims, rank=rank, world_size=world_size,
                          init_method=init_method, backend="nccl",
                          device="cuda")
    return dist_f32_check(mesh, DIST_TRAIN["seq"])


def one_process_first_step(depth: int, batch) -> dict:
    """Step 1's loss and each leaf's f64 gradient norm in one process on
    the card (phase ``lm_train_full``'s path, ``launch.train.build``'s
    loss): the microbatches of ``make_train_step`` (rows ``[i B/A,
    (i+1) B/A)``), gradients summed in f32 and divided by the
    accumulation."""
    from functools import partial

    import torch
    from repro_torch.models import transformer
    from repro_torch.models.convert import init_lm_params
    from repro_torch.train import pytree
    from repro_torch.train.steps import value_and_grad
    cfg = granite_train_cut(depth)
    accum = DIST_TRAIN["accum"]
    params = init_lm_params(cfg, seed=0, device="cuda")
    grads_of = value_and_grad(partial(transformer.train_loss, cfg))
    rows = batch["tokens"].shape[0] // accum
    loss, grads = 0.0, None
    for a in range(accum):
        mb = {k: v[a * rows:(a + 1) * rows] for k, v in batch.items()}
        lv, g = grads_of(params, mb)
        loss += float(lv)
        grads = (pytree.tree_map(lambda x: x.float(), g) if grads is None
                 else pytree.tree_map(torch.Tensor.add_, grads, g))
        del g
    grads = pytree.tree_map(lambda x: x / accum, grads)
    out = dict(loss=loss / accum, leaf_norms_f64=leaf_norms_f64(grads))
    del params, grads
    free_card()
    return out


def phase_lm_train_dist() -> dict:
    """granite-moe-3b-a800m at full width trained on
    ``make_host_mesh(data=2, model=2)``: four ranks on the one card over
    gloo (``launch.mesh.run_on_mesh``, spawned), sequence parallel and
    ZeRO, f32 state and bf16 compute, ``launch.train.build``'s step on
    ``synthetic_batch`` traffic of train_4k sequences, one per data rank
    per microbatch, accumulation 4, ``DIST_TRAIN["steps"]`` steps at
    ``DIST_TRAIN["depth"]`` layers (cuts for the run's time, printed as
    ``reduced``).

    1. The steps: step time (the steps after the first), the forward /
       backward / optimizer split (``StepSplit``, each rank's), the host
       time inside the collectives (``CollectiveClock``), tokens/s, MFU
       (the reference's ``model_flops``: 6 x active params x tokens over
       989 TFLOP/s), each rank's peak and state bytes; each rank must
       launch the sm90 flash kernel 2 times a layer-microbatch and the
       sm90 grouped GEMM 9 times, at its own shapes (12 / 4 heads, 24
       of the 48 experts).
    2. Step 1's loss and each leaf's f64 gradient norm against the same
       cut, batch and weights in one process (rank 0, before the mesh
       builds its state), the mesh's step 1 routed as the one process
       routed (``MeshRoutes``: a near tie may choose otherwise under
       the ranks' summation order), within ``TRAIN_FULL_TOL`` (the norm
       weights within ``DIST_NORM_GRAD_TOL``).
    3. The 2-layer cut in f32, four ranks against one process, routes
       pinned as in 2 (``DIST_F32_TOL`` per leaf); ``(1, 1)`` over NCCL
       against one process; ``(2, 2)`` over NCCL one rank per card where
       the machine has four cards, else printed as skipped.
    4. Both kernels at one rank's shapes (``lm_train_kernel_cases``).
    A rank that fails fails the phase.  Returns the launches summed over
    the ranks and the kernel readings."""
    import torch
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.models.transformer import abstract_params
    from repro_torch.train import pytree
    dt = DIST_TRAIN
    data, model = dt["dims"]
    world = data * model
    rdv = ROOT / "build" / "repro_torch" / "rendezvous"
    free_card()
    t0 = time.perf_counter()
    ranks = run_on_mesh(dist_train_rank, world, str(rdv / "gloo_2x2"),
                        args=("gloo",), timeout_s=900)
    mesh_s = time.perf_counter() - t0
    r0 = ranks[0]
    depth, seq, accum = r0["depth"], dt["seq"], dt["accum"]
    require(all(r["depth"] == depth for r in ranks),
            f"lm_train_dist: the ranks chose depths "
            f"{[r['depth'] for r in ranks]}")
    want = (2 * depth * accum, 9 * depth * accum)
    for r in ranks:
        require(all(tuple(x) == want for x in r["launches_per_step"])
                and r["launches"]["flash"]["simt"] == 0
                and r["launches"]["segment_matmul"]["simt"] == 0,
                f"lm_train_dist rank {r['rank']}: launches per step "
                f"{r['launches_per_step']}, not {want}; {r['launches']}")
        require(all(map(torch.isfinite, map(torch.as_tensor, r["losses"])))
                and r["losses"] == r0["losses"],
                f"lm_train_dist: losses {[x['losses'] for x in ranks]}")
    check = r0["check"]
    require(check["loss_rel_err"] <= DIST_F32_TOL
            and check["max_rel_l2"] <= DIST_F32_TOL,
            f"lm_train_dist f32 check, four ranks against one process: "
            f"{check}")

    # step 1 against one process, same cut, batch, weights and routes,
    # bf16 compute: the loss and each leaf's norm within TRAIN_FULL_TOL,
    # the norm weights' within DIST_NORM_GRAD_TOL
    one = {k: v for k, v in r0["one_process"].items() if k != "seconds"}
    rel = hold_first_step("lm_train_dist step 1 against one process",
                          r0["first_step"], one, TRAIN_FULL_TOL,
                          looser={leaf: DIST_NORM_GRAD_TOL
                                  for leaf in DIST_NORM_LEAVES})

    # NCCL: (1, 1) on this card; (2, 2) one rank per card where there
    # are four
    t0 = time.perf_counter()
    nccl = {"(1, 1)": run_on_mesh(dist_nccl_rank, 1, str(rdv / "nccl_1"),
                                  args=((1, 1),), timeout_s=300)[0]}
    if torch.cuda.device_count() >= world:
        nccl["(2, 2)"] = run_on_mesh(dist_nccl_rank, world,
                                     str(rdv / "nccl_2x2"),
                                     args=(dt["dims"],), timeout_s=300)[0]
    else:
        nccl["(2, 2)"] = (f"skipped: {torch.cuda.device_count()} card(s), "
                          f"NCCL takes one rank per card")
    for name, res in nccl.items():
        if isinstance(res, dict):
            require(res["loss_rel_err"] <= DIST_F32_TOL
                    and res["max_rel_l2"] <= DIST_F32_TOL,
                    f"lm_train_dist nccl {name}: {res}")
    nccl_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg = granite_train_cut(depth)
    width = -(-int(r0["slot_fill"]["width_median"]) // 8) * 8
    kernels = lm_train_kernel_cases(
        cfg, heads=(cfg.n_heads // model, cfg.n_kv_heads // model),
        experts=cfg.e_pad // model, width=width)
    kernels_s = time.perf_counter() - t0
    tokens = accum * data * seq
    step_s = max(r["step_s"] for r in ranks)
    n_params = sum(x.numel() for x in pytree.leaves(abstract_params(cfg)))
    emit({"phase": "lm_train_dist", "arch": cfg.name,
          "mesh": {"data": data, "model": model}, "backend": "gloo",
          "ranks_on": f"cuda:0 x {world} (one card)",
          "sp": True, "zero": True,
          "reduced": {"n_layers": [depth, get_full_depth(),
                                   "the run's time limit: a fixed depth "
                                   "(10 before, the deepest the four "
                                   "ranks' summed peak let fit, probed at "
                                   "2 and 4 layers)"],
                      "batch": [f"{accum} x {data} x {seq} tokens a step",
                                "train_4k: 256 x 4096",
                                "the run's time limit"],
                      "steps": [dt["steps"], 3, "the run's time limit"]},
          "total_bytes": r0["total_bytes"],
          "init_s": r0["init_s"], "mesh_run_s": mesh_s,
          "step_ms": {r["rank"]: r["step_ms"] for r in ranks},
          "step_ms_after_first": 1e3 * step_s,
          "collective_ms": {r["rank"]: r["collective_ms"] for r in ranks},
          "split_ms": {r["rank"]: r["split_ms"] for r in ranks},
          "tokens_per_s": tokens / step_s,
          "mfu": 6 * cfg.active_param_count() * tokens / step_s
          / BF16_FLOPS_PER_S,
          "losses": r0["losses"],
          "peak_bytes": {r["rank"]: r["peak_bytes"] for r in ranks},
          "state_bytes": {r["rank"]: r["state_bytes"] for r in ranks},
          "state_bytes_one_process": 12 * n_params,
          "launches_per_step": {r["rank"]: r["launches_per_step"][0]
                                for r in ranks},
          "first_step": {"mesh": r0["first_step"]["loss"],
                         "one_process": one["loss"],
                         "max_rel_err": max(rel.values()),
                         "rel_err": rel, "tol": TRAIN_FULL_TOL,
                         "norm_leaf_tol": DIST_NORM_GRAD_TOL,
                         "one_process_s": r0["one_process"]["seconds"],
                         "route_flips": {r["rank"]: r["route_flips"]
                                         for r in ranks}},
          "f32_check": dict(check, tol=DIST_F32_TOL,
                            check_s=r0["check_s"]),
          "slot_fill": {r["rank"]: r["slot_fill"] for r in ranks},
          "nccl": nccl, "nccl_s": nccl_s, "kernels_s": kernels_s,
          "kernels": kernels})
    launches = {k: sum(r["launches"][k]["sm90"] for r in ranks)
                for k in ("flash", "segment_matmul")}
    return dict(depth=depth, launches=launches, kernels=kernels)


def on_rank0(mesh, fn):
    """``fn()`` on rank 0 alone while the other ranks wait; every rank
    gets its result."""
    import torch.distributed as dist
    box = [fn() if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def gnn_dist_cell(arch: str) -> tuple:
    """``(cfg, d_in, d_out, numpy batch)`` of the reference's sharded
    minibatch_lg cell of ``arch`` on ``(data=4, model=1)``: the config
    (the cell's remat group), widths and batch layout of
    ``repro_torch.launch.specs.build_cell`` (its ``PERF`` entry: the
    sampled subgraph consumed as one padded graph, ``n = 1024 (1 + 15)(1
    + 10)`` = 180,224 nodes and ``16,384 x 10 + 1024 x 15`` = 179,200
    edges, a multiple of 512: no pad; GraphCast with its 7,208 mesh
    nodes, 360,448 g2m and m2g edges (every grid node twice), 57,856
    mesh edges (57,664 padded), the sharded cell's grid mask and the
    plain edge arrays the cell keeps but GraphCast does not read), random
    from numpy seed 0 and held to the cell's layout."""
    import numpy as np
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.launch.mesh import layout_mesh
    from repro_torch.launch.specs import build_cell
    from repro_torch.testing import gnn_full_batch
    cell = build_cell(arch, "minibatch_lg", layout_mesh((GNN_DIST["data"],
                                                          1)))
    require(not cell.runs_whole, f"{arch} x minibatch_lg: not a sharded "
            "cell")
    sh, cfg = GNN_SHAPES["minibatch_lg"], cell.cfg
    f1, f2 = sh["fanout"]
    n = cell.args[2]["feats"].shape[0]
    e = sh["batch_nodes"] * ((1 + f1) * f2 + f1)
    r = np.random.default_rng(0)
    batch = gnn_full_batch(cfg, r, n, e, cell.d_in, sh["n_classes"])
    if cfg.kind == "graphcast":
        batch["grid_mask"] = np.ones(n, np.float32)
        # the cell's plain edge arrays, which GraphCast does not read
        for k in ("senders", "receivers"):
            batch[k] = r.integers(0, n, e).astype(np.int32)
    layout_of(cell, batch)
    return cfg, cell.d_in, cell.d_out, batch


def gnn_dist_rank(rank: int, world_size: int, init_method: str) -> dict:
    """One rank of phase ``gnn_train_dist``: for each cell, step 1's loss
    and every leaf's f64 gradient norm (``make_sharded_gnn_loss`` on the
    rank's piece, the gradient summed over the data axes), then
    ``GNN_DIST["steps"]`` f32 AdamW steps of ``make_train_step`` cutting
    the rank's piece (``local_batch``): step times, the host's time in
    collectives, collective calls, the peak."""
    import statistics
    from functools import partial

    import torch
    from repro_torch.dist.gnn_sharded import local_batch, \
        make_sharded_gnn_loss
    from repro_torch.dist.sharding import gnn_param_shardings
    from repro_torch.models.convert import numpy_gnn_params, tree_from_numpy
    from repro_torch.testing import to_torch
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import (make_train_step, sum_over_data,
                                         value_and_grad)
    mesh = dist_rank_mesh(rank, world_size, init_method, GNN_DIST["data"], 1)
    clock = CollectiveClock()
    steps = GNN_DIST["steps"]
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    out = {}
    for arch in GNN_DIST["cells"]:
        cfg, d_in, d_out, batch = gnn_dist_cell(arch)
        params = tree_from_numpy(numpy_gnn_params(cfg, d_in, d_out, seed=0),
                                 device=mesh.device)
        full = to_torch(batch, mesh.device)
        del batch
        cut = partial(local_batch, cfg, mesh=mesh)
        loss_fn = make_sharded_gnn_loss(cfg, mesh, full)
        specs = gnn_param_shardings(params, mesh)
        local = cut(full)
        edges = {k: len(v) for k, v in local.items()
                 if k.endswith("senders")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, grads = value_and_grad(loss_fn)(params, local)
        grads = sum_over_data(grads, mesh, specs)
        first = dict(loss=float(loss), leaf_norms_f64=leaf_norms_f64(grads))
        first_s = time.perf_counter() - t0
        del grads, local
        step = make_train_step(loss_fn, opt_cfg, mesh=mesh,
                               param_specs=specs, share=cut)
        opt = adamw_init(params)
        times, coll, calls, losses = [], [], [], []
        for s in range(steps):
            torch.cuda.synchronize()
            c0, n0, t1 = clock.seconds, clock.calls, time.perf_counter()
            params, opt, m = step(params, opt, full)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            coll.append(clock.seconds - c0)
            calls.append(clock.calls - n0)
            losses.append(float(m["loss"]))
        out[arch] = dict(
            first=first, first_s=first_s, local_edges=edges,
            step_ms=[1e3 * t for t in times],
            step_ms_after_first=(1e3 * statistics.median(times[1:])
                                 if len(times) > 1 else None),
            collective_ms=[1e3 * c for c in coll],
            collective_calls_per_step=calls, losses=losses,
            optimizer_grad_norm_f32=float(m["grad_norm"]),
            peak_bytes=torch.cuda.max_memory_allocated())
        progress(rank, f"{arch}: steps {[round(t, 3) for t in times]} s",
                 "gnn_train_dist")
        del params, opt, full, step, loss_fn
        free_card()
    return dict(rank=rank, coords=mesh.coords, cells=out)


def ogb_products_cards() -> dict:
    """The arithmetic behind leaving the ``ogb_products`` cells off one
    card: each cell's edge tensors alone (f32, 61,859,328 padded edges;
    ranks sharing a card share its memory, so sharding edges over them
    lowers no summed peak) against one card's memory less
    ``DIST_TRAIN_MARGIN``; the cards they need at the least (edge
    tensors divide over the cards, node tensors do not)."""
    import math

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import GNN_SHAPES
    sh = GNN_SHAPES["ogb_products"]
    n = sh["n_nodes"]
    e = -(-sh["n_edges"] // 512) * 512
    card = torch.cuda.get_device_properties(0).total_memory
    usable = card * (1 - DIST_TRAIN_MARGIN)
    from repro_torch.launch.specs import PERF
    gat, ggcn, gc = (get_config(a) for a in ("gat-cora", "gatedgcn",
                                              "graphcast"))
    group = PERF[("gatedgcn", "ogb_products")]["remat_group"]
    d, dg = ggcn.d_hidden, gc.d_hidden
    g2 = 2 * n                                    # g2m = m2g edges
    cells = {
        "gat-cora": (2 * e * gat.n_heads * sh["n_classes"] * 4,
                     "the last layer's z[senders] and its message, "
                     f"[E, {gat.n_heads}, {sh['n_classes']}] f32 each"),
        "gatedgcn": ((5 * group + ggcn.n_layers // group) * e * d * 4,
                     f"a remat group's {group} layers x 5 [E, {d}] f32 "
                     "tensors, and the edge state at each group boundary"),
        "graphcast": (2 * g2 * (3 * dg + 3 * dg) * 4,
                      f"g2m and m2g: [2n, {3 * dg}] edge inputs and three "
                      f"[2n, {dg}] MLP tensors each"),
    }
    out = {"edges": e, "nodes": n, "card_bytes": card,
           "usable_bytes": usable}
    for arch, (nbytes, what) in cells.items():
        out[arch] = dict(edge_bytes=nbytes, what=what,
                         cards_at_least=math.ceil(nbytes / usable))
    out["gat-cora"]["z_senders_bytes"] = out["gat-cora"]["edge_bytes"] / 2
    return out


def phase_gnn_train_dist() -> None:
    """The reference's sharded GNN cells that one card holds
    (``launch/specs.py`` ``PERF``: ``sharded_gnn=True`` on minibatch_lg;
    ``gnn_dist_cell``), each trained edge-parallel on
    ``make_host_mesh(data=4, model=1)``: four gloo ranks sharing the
    card (``gnn_dist_rank``), ``GNN_DIST["steps"]`` f32 AdamW steps.
    Step 1's loss and every leaf's f64 gradient norm held to one process
    on the card (this process, before the ranks start) within
    ``TRAIN_FULL_TOL``; every rank's losses equal.  The GNN path runs no
    hand-written kernel (the reference's has no Pallas kernel): its
    launches are torch ops, its collectives counted per step.  The
    ``ogb_products`` cells are left off with their arithmetic
    (``ogb_products_cards``)."""
    from functools import partial

    import torch
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.models import gnn
    from repro_torch.models.convert import numpy_gnn_params, tree_from_numpy
    from repro_torch.testing import to_torch
    torch.backends.cuda.matmul.allow_tf32 = False       # f32, as the ranks
    one, dims = {}, {}
    for arch in GNN_DIST["cells"]:
        free_card()
        cfg, d_in, d_out, batch = gnn_dist_cell(arch)
        dims[arch] = cfg, d_in, d_out
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        one[arch] = first_step(
            partial(gnn.train_loss, cfg),
            tree_from_numpy(numpy_gnn_params(cfg, d_in, d_out, seed=0),
                            device="cuda"),
            to_torch(batch, "cuda"), by_leaf=True)
        one[arch].update(seconds=time.perf_counter() - t0,
                         peak_bytes=torch.cuda.max_memory_allocated())
    free_card()
    rdv = ROOT / "build" / "repro_torch" / "rendezvous"
    t0 = time.perf_counter()
    ranks = run_on_mesh(gnn_dist_rank, GNN_DIST["data"],
                        str(rdv / "gnn_4x1"), timeout_s=900)
    mesh_s = time.perf_counter() - t0
    for arch in GNN_DIST["cells"]:
        cells = [r["cells"][arch] for r in ranks]
        r0 = cells[0]
        require(all(c["losses"] == r0["losses"] for c in cells),
                f"gnn_train_dist {arch}: the ranks' losses differ: "
                f"{[c['losses'] for c in cells]}")
        mine = {k: v for k, v in one[arch].items()
                if k in ("loss", "leaf_norms_f64")}
        rel = hold_first_step(f"gnn_train_dist {arch} step 1 against one "
                              "process", r0["first"], mine, TRAIN_FULL_TOL,
                              r0["losses"])
        cfg, d_in, d_out = dims[arch]
        emit({"phase": "gnn_train_dist", "arch": arch,
              "shape": "minibatch_lg", "mesh": {"data": GNN_DIST["data"],
                                                "model": 1},
              "backend": "gloo",
              "ranks_on": f"cuda:0 x {GNN_DIST['data']} (one card)",
              "d_hidden": cfg.d_hidden, "n_layers": cfg.n_layers,
              "remat_group": cfg.remat_group, "d_in": d_in, "d_out": d_out,
              "local_edges": {r["rank"]: r["cells"][arch]["local_edges"]
                              for r in ranks},
              "steps": GNN_DIST["steps"],
              "reduced": {"steps": [GNN_DIST["steps"], 3,
                                    "the run's time limit"]},
              "step_ms_after_first": max(c["step_ms_after_first"]
                                         for c in cells),
              "step_ms": {r["rank"]: r["cells"][arch]["step_ms"]
                          for r in ranks},
              "collective_ms": {r["rank"]: r["cells"][arch]["collective_ms"]
                                for r in ranks},
              "collective_calls_per_step": r0["collective_calls_per_step"],
              "kernel_launches_per_rank": 0, "losses": r0["losses"],
              "first_step": {"mesh_loss": r0["first"]["loss"],
                             "one_process_loss": one[arch]["loss"],
                             "max_rel_err": max(rel.values()),
                             "tol": TRAIN_FULL_TOL,
                             "mesh_s": r0["first_s"],
                             "one_process_s": one[arch]["seconds"]},
              "optimizer_grad_norm_f32": r0["optimizer_grad_norm_f32"],
              "peak_bytes": {r["rank"]: r["cells"][arch]["peak_bytes"]
                             for r in ranks},
              "peak_bytes_summed": sum(c["peak_bytes"] for c in cells),
              "peak_bytes_one_process": one[arch]["peak_bytes"]})
    emit({"phase": "gnn_train_dist", "mesh_run_s": mesh_s,
          "ogb_products_not_run": ogb_products_cards()})


def recsys_one_process_first(cfg, batch) -> dict:
    """Step 1 of ``launch.train.build``'s DCN-v2 loss (seed-0 f32
    weights, bf16 forward) in one process on the card: the loss and each
    leaf's f64 gradient norm."""
    from functools import partial

    import torch
    from repro_torch.models import recsys
    from repro_torch.models.convert import init_recsys
    params = init_recsys(cfg, seed=0, device="cuda", dtype=torch.float32)
    out = first_step(partial(recsys.train_loss, cfg), params, batch,
                     by_leaf=True)
    del params
    free_card()
    return out


def recsys_dist_rank(rank: int, world_size: int, init_method: str) -> dict:
    """One rank of phase ``recsys_train_dist`` (``phase_recsys_train_
    dist``)."""
    import statistics

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.core import rng
    from repro_torch.dist.collectives import all_gather_dim
    from repro_torch.dist.sharding import data_axes, unshard
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.launch.train import build, state_specs, synthetic_batch
    from repro_torch.models import recsys
    from repro_torch.models.layers import cast_for_compute
    from repro_torch.train import steps as steps_mod
    from repro_torch.train.steps import compress_decompress, data_share
    rd = RECSYS_DIST
    mesh = dist_rank_mesh(rank, world_size, init_method, rd["data"],
                          rd["model"])
    clock = CollectiveClock()
    cfg = get_config("dcn-v2")
    B, steps = RECSYS_SHAPES["train_batch"]["batch"], rd["steps"]
    batches = [synthetic_batch(cfg, B, 0, s * 1000, mesh.device)
               for s in range(steps)]
    t0 = time.perf_counter()
    one = on_rank0(mesh, lambda: recsys_one_process_first(cfg, batches[0]))
    one_s = time.perf_counter() - t0
    free_card()
    progress(rank, f"one process, step 1: loss {one['loss']:.6f}",
             "recsys_train_dist")

    t0 = time.perf_counter()
    state, do_step = build(cfg, 3e-4, steps + 1, device="cuda", mesh=mesh,
                           zero=rd["zero"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    specs = state_specs(cfg, mesh, rd["zero"])
    captured = {}
    own_update = steps_mod.adamw_update

    def capture(opt_cfg, grads, opt_state, params, **kw):
        # step 1's gradient as the optimizer receives it (summed over
        # the data axes): every leaf's f64 norm, the table's piece kept
        # on the host for the quantizer's check
        if not captured:
            captured["leaf_norms_f64"] = leaf_norms_f64(
                grads, mesh, kw["state_specs"].mu)
            captured["table"] = grads["table"].cpu()
        return own_update(opt_cfg, grads, opt_state, params, **kw)
    steps_mod.adamw_update = capture
    times, coll, launches, losses, peaks = [], [], [], [], []
    for s in range(steps):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n0, c0, t1 = embedding_bag.launches, clock.seconds, \
            time.perf_counter()
        state, m = do_step(state, batches[s], s)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        coll.append(clock.seconds - c0)
        launches.append(embedding_bag.launches - n0)
        losses.append(m["loss"])
        peaks.append(torch.cuda.max_memory_allocated())
        progress(rank, f"step {s + 1}: {times[-1]:.2f} s, collectives "
                 f"{coll[-1]:.2f} s, loss {losses[-1]:.6f}",
                 "recsys_train_dist")
    steps_mod.adamw_update = own_update
    local_rows = state["params"]["table"].shape[0]
    del batches

    # serving on the mesh, bf16 weights: serve_bulk (each data rank its
    # rows) and retrieval_cand, against one process on the same rows
    # with the full table (gathered over model)
    sp = cast_for_compute(state["params"], torch.bfloat16)
    del state
    free_card()
    one_p = dict(sp, table=unshard(sp["table"],
                                   specs["params"]["table"], mesh))
    r = np.random.default_rng(0)
    nb = RECSYS_SHAPES["serve_bulk"]["batch"]
    bulk = dict(dense=torch.as_tensor(r.standard_normal((nb, cfg.n_dense)),
                                      dtype=torch.float32).cuda(),
                sparse=recsys_ids(cfg, nb, r))
    mine = {k: data_share(v, mesh) for k, v in bulk.items()}
    n0 = embedding_bag.launches
    feats = recsys.sparse_features(cfg, sp, mine["sparse"], mesh)
    serve_launches = embedding_bag.launches - n0
    equal = dict(serve_bulk_features=torch.equal(
        feats, recsys.sparse_features(cfg, one_p, mine["sparse"])))
    del feats
    logits = recsys.forward(cfg, sp, mine, mesh=mesh)
    equal["serve_bulk_logits"] = torch.equal(
        logits, recsys.forward(cfg, one_p, mine))
    gathered = all_gather_dim(logits.float(), 0,
                              mesh.group(data_axes(mesh)))
    whole = recsys.forward(cfg, one_p, bulk).float()
    full_batch_diff = float((gathered - whole).abs().max())
    serve_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        recsys.forward(cfg, sp, mine, mesh=mesh)
        torch.cuda.synchronize()
        serve_ms.append(1e3 * (time.perf_counter() - t1))
    del logits, gathered, whole, bulk, mine
    n_cand = RECSYS_SHAPES["retrieval_cand"]["n_candidates"]
    q = dict(dense=torch.as_tensor(r.standard_normal((1, cfg.n_dense)),
                                   dtype=torch.float32).cuda(),
             sparse=recsys_ids(cfg, 1, r),
             cand_ids=torch.as_tensor(
                 r.integers(0, cfg.table_sizes[0], n_cand)).cuda())
    scores = recsys.serve_retrieval(cfg, sp, q, mesh=mesh)
    equal["retrieval_cand_scores"] = torch.equal(
        scores, recsys.serve_retrieval(cfg, one_p, q))
    retrieval_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        recsys.serve_retrieval(cfg, sp, q, mesh=mesh)
        torch.cuda.synchronize()
        retrieval_ms.append(1e3 * (time.perf_counter() - t1))
    del sp, one_p, scores, q
    free_card()

    # the sharded quantizer on step 1's table gradient: this rank's rows
    # against the meshless quantizer on the gathered leaf, same key
    g = captured.pop("table").to(mesh.device)
    spec = specs["opt"].mu["table"]
    key = rng.PRNGKey(rd["key"])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = compress_decompress(g, key, mesh, spec)
    torch.cuda.synchronize()
    quant_ms = 1e3 * (time.perf_counter() - t1)
    full = unshard(g, spec, mesh)
    del g
    t1 = time.perf_counter()
    want = compress_decompress(full, key)
    torch.cuda.synchronize()
    quant_full_ms = 1e3 * (time.perf_counter() - t1)
    off = mesh.coord("model") * local_rows
    equal["quantizer_table_rows"] = torch.equal(got,
                                                want[off:off + local_rows])
    leaf_elems = full.numel()
    del got, want, full
    free_card()
    return dict(rank=rank, coords=mesh.coords, one_process=one,
                one_process_s=one_s, init_s=init_s, local_rows=local_rows,
                step_ms=[1e3 * t for t in times],
                step_s=statistics.median(times[1:]),
                collective_ms=[1e3 * c for c in coll],
                launches_per_step=launches, losses=losses,
                peak_bytes=max(peaks), first_step=dict(loss=losses[0],
                                                       **captured),
                serve_bulk_launches=serve_launches,
                serve_bulk_ms=serve_ms, retrieval_ms=retrieval_ms,
                full_batch_max_abs_diff=full_batch_diff, equal=equal,
                quantizer_ms=quant_ms, quantizer_full_leaf_ms=quant_full_ms,
                table_leaf_elements=leaf_elems)


def eb_rank_case(cfg) -> dict:
    """The EmbeddingBag kernel at one rank's shapes on the mesh of phase
    ``recsys_train_dist``: data rank 0's 32,768 rows of the first
    ``train_batch`` (26 bags of one id each) into model rank 0's
    31,494,144 local rows of the bf16 table, foreign ids ``-1``, the f32
    output mode; held to its plain version bit for bit, timed beside its
    bound (the bytes of this run's ids: every id read, the rows of the
    local ids read, the f32 output written) and ``F.embedding_bag``; also
    the kernel's own duration (a device-only profile of 20 calls) and the
    wrapper's host time a call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import recsys
    rd = RECSYS_DIST
    rows = cfg.v_total // rd["model"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = (torch.randn((rows, cfg.embed_dim), generator=gen,
                         device="cuda").mul_(0.01).to(torch.bfloat16))
    B = RECSYS_SHAPES["train_batch"]["batch"]
    sparse = synthetic_batch(cfg, B, 0, 0, "cuda")["sparse"][:B // rd["data"]]
    gid = (sparse.long() + recsys.table_offsets(cfg, "cuda")).reshape(-1, 1)
    lid = recsys.local_ids(gid, 0, rows, cfg.v_total)  # model rank 0's
    got = embedding_bag(table, lid, out_dtype=torch.float32)
    want = embedding_bag_ref(table, lid, out_dtype=torch.float32)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "embedding_bag at a rank's shapes: "
            "kernel != plain version bit for bit")
    n, valid = lid.shape[0], int((lid >= 0).sum())
    nbytes = n * 8 + valid * cfg.embed_dim * 2 + n * cfg.embed_dim * 4
    w = (lid >= 0).to(table.dtype)
    safe = lid.clamp(min=0)

    def call():
        return embedding_bag(table, lid, out_dtype=torch.float32)
    return dict(
        case=f"a rank of (data={rd['data']}, model={rd['model']}): "
             f"{B // rd['data']} x {cfg.n_sparse} bags of one id into "
             f"{rows} local rows, {valid} of {n} ids local, bf16 table, "
             "f32 output", bags=n, local_ids=valid, bytes=nbytes,
        ms=cuda_ms(call, reps=20),
        profiler_ms=kernel_device_ms(call, "embedding_bag_kernel", 20),
        host_us=host_us_per_call(call),
        plain_ms=cuda_ms(lambda: embedding_bag_ref(
            table, lid, out_dtype=torch.float32), reps=3),
        library_ms=cuda_ms(lambda: F.embedding_bag(
            safe, table, mode="sum", per_sample_weights=w), reps=20),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        max_abs_err=0.0)


def phase_recsys_train_dist() -> tuple[int, dict]:
    """DCN-v2 at full size (the 62,988,288 x 16 table) trained on
    ``make_host_mesh(data=2, model=2)``: four gloo ranks sharing the
    card, the reference's ``_recsys_cell`` layout (the table by rows
    over ``"model"``, every other leaf replicated, no ZeRO),
    ``launch.train.build``'s step on ``synthetic_batch`` traffic at
    train_batch 65,536 (32,768 rows a data rank), f32 state, bf16
    forward, ``RECSYS_DIST["steps"]`` steps (``recsys_dist_rank``):

    1. step 1's loss within ``TRAIN_FULL_TOL`` and every leaf's f64
       gradient norm within ``BF16_GRAD_TOL`` of one process on the card
       (rank 0, before the mesh builds its state);
    2. one EmbeddingBag launch a rank a step, on the rank's rows;
    3. serve_bulk (262,144 rows) and retrieval_cand (1 M candidates) on
       the mesh: the lookups, logits and scores bit-equal to one process
       on the same rows (bags of one id), the full batch's one-process
       logits beside the gathered ones (a reading);
    4. the sharded quantizer on step 1's table-gradient leaf bit-equal,
       on every rank's rows, to the meshless one on the gathered leaf;
    5. the kernel at one rank's shapes (``eb_rank_case``).
    Returns the launches summed over the ranks and the kernel's
    readings."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.launch.mesh import run_on_mesh
    rd = RECSYS_DIST
    world = rd["data"] * rd["model"]
    free_card()
    rdv = ROOT / "build" / "repro_torch" / "rendezvous"
    t0 = time.perf_counter()
    ranks = run_on_mesh(recsys_dist_rank, world, str(rdv / "recsys_2x2"),
                        timeout_s=900)
    mesh_s = time.perf_counter() - t0
    r0 = ranks[0]
    for r in ranks:
        require(r["launches_per_step"] == [1] * rd["steps"]
                and r["serve_bulk_launches"] == 1,
                f"recsys_train_dist rank {r['rank']}: embedding_bag "
                f"launches {r['launches_per_step']} a step, "
                f"{r['serve_bulk_launches']} a serve_bulk lookup")
        require(r["losses"] == r0["losses"]
                and all(map(torch.isfinite, map(torch.as_tensor,
                                                r["losses"]))),
                f"recsys_train_dist: losses "
                f"{[x['losses'] for x in ranks]}")
        require(all(r["equal"].values()),
                f"recsys_train_dist rank {r['rank']}: not equal to one "
                f"process: {r['equal']}")
    one = r0["one_process"]
    first = r0["first_step"]
    rel = dict(
        loss=hold_first_step("recsys_train_dist step 1 loss",
                             {"loss": first["loss"]}, {"loss": one["loss"]},
                             TRAIN_FULL_TOL),
        leaves=hold_first_step(
            "recsys_train_dist step 1 gradient against one process",
            {"g": first["leaf_norms_f64"]}, {"g": one["leaf_norms_f64"]},
            BF16_GRAD_TOL))
    cfg = get_config("dcn-v2")
    t0 = time.perf_counter()
    kernel = eb_rank_case(cfg)
    free_card()
    emit({"phase": "recsys_train_dist", "arch": cfg.name,
          "mesh": {"data": rd["data"], "model": rd["model"]},
          "backend": "gloo", "ranks_on": f"cuda:0 x {world} (one card)",
          "zero": rd["zero"], "local_rows": r0["local_rows"],
          "batch": RECSYS_SHAPES["train_batch"]["batch"],
          "steps": rd["steps"], "mesh_run_s": mesh_s,
          "reduced": {"steps": [rd["steps"], 3, "the run's time limit"]},
          "step_ms_after_first": 1e3 * max(r["step_s"] for r in ranks),
          "step_ms": {r["rank"]: r["step_ms"] for r in ranks},
          "collective_ms": {r["rank"]: r["collective_ms"] for r in ranks},
          "losses": r0["losses"],
          "embedding_bag_launches_per_step": {r["rank"]:
                                              r["launches_per_step"]
                                              for r in ranks},
          "peak_bytes": {r["rank"]: r["peak_bytes"] for r in ranks},
          "peak_bytes_summed": sum(r["peak_bytes"] for r in ranks),
          "init_s": r0["init_s"],
          "first_step": {"mesh_loss": first["loss"],
                         "one_process_loss": one["loss"],
                         "loss_rel_err": rel["loss"]["loss"],
                         "max_leaf_rel_err": max(rel["leaves"].values()),
                         "leaf_rel_err": rel["leaves"],
                         "tol": TRAIN_FULL_TOL,
                         "leaf_tol": BF16_GRAD_TOL,
                         "one_process_s": r0["one_process_s"]},
          "serve_bulk_ms": {r["rank"]: r["serve_bulk_ms"] for r in ranks},
          "retrieval_cand_ms": {r["rank"]: r["retrieval_ms"]
                                for r in ranks},
          "serve_full_batch_max_abs_diff": r0["full_batch_max_abs_diff"],
          "equal": {r["rank"]: r["equal"] for r in ranks},
          "quantizer_ms": {r["rank"]: r["quantizer_ms"] for r in ranks},
          "quantizer_full_leaf_ms": r0["quantizer_full_leaf_ms"],
          "table_leaf_elements": r0["table_leaf_elements"],
          "kernel": kernel, "kernel_s": time.perf_counter() - t0})
    return sum(sum(r["launches_per_step"]) for r in ranks), kernel


def pipeline_rank(rank: int, world_size: int, init_method: str) -> dict:
    """One rank of phase ``pipeline``: ``gpipe_forward`` of ``tanh(h @
    W)`` stages (``PIPELINE``), a warm-up then timed runs; rank 0 also
    applies the stages serially, each microbatch through each stage (the
    same products), while the others wait."""
    import statistics

    import torch
    import torch.distributed as dist
    from repro_torch.dist.pipeline import gpipe_forward
    pl = PIPELINE
    mesh = dist_rank_mesh(rank, world_size, init_method, 1, 1,
                          pod=pl["stages"])
    clock = CollectiveClock()
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    d = pl["d"]
    ws = torch.randn((pl["stages"], d, d), generator=gen,
                     device=mesh.device) * d ** -0.5
    xs = torch.randn((pl["microbatches"], pl["rows"], d), generator=gen,
                     device=mesh.device)

    def stage(w, h):
        return torch.tanh(h @ w)
    out = gpipe_forward(stage, ws, xs, mesh)
    times, coll = [], []
    for _ in range(pl["reps"]):
        dist.barrier()
        torch.cuda.synchronize()
        c0, t0 = clock.seconds, time.perf_counter()
        out = gpipe_forward(stage, ws, xs, mesh)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        coll.append(clock.seconds - c0)

    def serial():
        outs = []
        for x in xs:
            for w in ws:
                x = stage(w, x)
            outs.append(x)
        return torch.stack(outs)
    res = {}
    if rank == 0:
        want = serial()
        res = dict(max_abs_err=float((out - want).abs().max()),
                   serial_ms=cuda_ms(serial, reps=3))
        del want
    dist.barrier()
    return dict(rank=rank, ms=[1e3 * t for t in times],
                ms_median=1e3 * statistics.median(times),
                collective_ms=[1e3 * c for c in coll],
                peak_bytes=torch.cuda.max_memory_allocated(), **res)


def phase_pipeline() -> None:
    """``dist.pipeline.gpipe_forward`` on ``make_host_mesh(pod=4, data=1,
    model=1)``: four gloo ranks sharing the card, ``tanh(h @ W)`` stages
    at width 4096 (granite-8b's ``d_model``), 8 microbatches of 2048
    rows, f32 without TF32; within ``PIPELINE["tol"]`` of serial
    application on the card, each timed.  Forward only, as the
    reference; the stage-to-stage shift is an all-gather over gloo."""
    from repro_torch.launch.mesh import run_on_mesh
    pl = PIPELINE
    free_card()
    rdv = ROOT / "build" / "repro_torch" / "rendezvous"
    t0 = time.perf_counter()
    ranks = run_on_mesh(pipeline_rank, pl["stages"], str(rdv / "gpipe_4"),
                        timeout_s=600)
    r0 = ranks[0]
    require(r0["max_abs_err"] <= pl["tol"],
            f"pipeline: gpipe_forward against serial, max |err| "
            f"{r0['max_abs_err']} (tol {pl['tol']})")
    emit({"phase": "pipeline", "mesh": {"pod": pl["stages"], "data": 1,
                                        "model": 1},
          "backend": "gloo", "ranks_on": f"cuda:0 x {pl['stages']}",
          "stages": pl["stages"], "d": pl["d"],
          "microbatches": pl["microbatches"], "rows": pl["rows"],
          "steps": pl["microbatches"] + pl["stages"] - 1,
          "max_abs_err": r0["max_abs_err"], "tol": pl["tol"],
          "gpipe_ms_median": max(r["ms_median"] for r in ranks),
          "gpipe_ms": {r["rank"]: r["ms"] for r in ranks},
          "collective_ms": {r["rank"]: r["collective_ms"] for r in ranks},
          "serial_ms": r0["serial_ms"],
          "peak_bytes": {r["rank"]: r["peak_bytes"] for r in ranks},
          "phase_s": time.perf_counter() - t0})


def get_full_depth() -> int:
    from repro_torch.configs import get_config
    return get_config(FULL_TRAIN["arch"]).n_layers


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph", default=FULL_GRAPH,
                    help="full-size graph spec (default: wiki-talk scale)")
    ap.add_argument("--motif", default="M5-3")
    ap.add_argument("--delta", type=int, default=3600)
    ap.add_argument("--k", type=int, default=1 << 20)
    ap.add_argument("--chunk", type=int, default=8192)
    args = ap.parse_args()

    import gc

    import torch
    require(torch.cuda.is_available(), "no CUDA device")
    require((ROOT / "src" / "repro_torch" / "__init__.py").exists(),
            "src/repro_torch not found next to chip_smoke.py")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import get_motif
    from repro_torch.core.spanning_tree import candidate_trees
    from repro_torch.core.weights import preprocess
    from repro_torch.launch.estimate import parse_graph

    timed("card", phase_card)
    ptxas = timed("build", phase_build)

    t0 = time.perf_counter()
    g = timed("graph", parse_graph, args.graph)
    emit({"phase": "graph", "spec": args.graph, "n": g.n, "m": g.m,
          "time_span": g.time_span, "seconds": time.perf_counter() - t0})

    # one real candidate tree of the main path, preprocessed at full size
    tree = candidate_trees(get_motif(args.motif), n_candidates=3,
                           roots_per_tree=2)[0]
    dev = g.device_arrays("cuda")
    wts = timed("preprocess", preprocess, g, tree, args.delta, dev=dev)
    recs = [timed("interval_weight", phase_interval_weight, dev, wts, tree),
            timed("tree_sampler", phase_tree_sampler, g, dev, wts, tree,
                  args.chunk)]
    del dev, wts
    torch.cuda.empty_cache()

    timed("small", phase_small)
    launches, full = timed("full", phase_full, g, args.motif, args.delta,
                           args.k, args.chunk)
    timed("breakdown", phase_breakdown, g, args.motif, args.delta,
          args.chunk)
    service, cohort = timed("service", phase_service, g, args.delta, args.k,
                            args.chunk, full)
    for rec in recs:
        rec["launches"] = launches[rec["name"]]
        rec["launches_service"] = service[rec["name"]]
    recs[1].update(cohort_streams=len(COHORT_SEEDS),
                   launches_per_cohort_chunk=service["tree_sampler"]
                   / -(-args.k // args.chunk))
    gc.collect()
    torch.cuda.empty_cache()
    timed("oracle", phase_oracle, args.chunk, args.k)
    timed("stream_small", phase_stream_small)
    stream, padded_err = timed("stream", phase_stream, g, args.chunk, args.k)
    for rec in recs:
        rec["launches_stream"] = stream[rec["name"]]
        rec["max_abs_err_padded"] = padded_err[rec["name"]]
    gateway = timed("gateway", phase_gateway, g, args.graph, args.delta,
                    args.k, args.chunk, full)
    for rec in recs:
        rec["launches_gateway"] = gateway[rec["name"]]
    mesh = timed("mesh", phase_mesh, g, args.motif, args.delta, args.k,
                 args.chunk, full, cohort)
    for rec in recs:
        rec["launches_mesh"] = mesh[rec["name"]]
    del g, full, cohort
    gc.collect()
    torch.cuda.empty_cache()

    fa, fa_simt = timed("flash_attention", phase_flash_attention)
    fa_simt["ptxas"] = ptxas["flash_attention"]
    torch.cuda.empty_cache()
    sm, sm_simt = timed("segment_matmul", phase_segment_matmul)
    sm_simt["ptxas"] = ptxas["segment_matmul"]
    eb = timed("embedding_bag", phase_embedding_bag)
    eb["ptxas"] = ptxas["embedding_bag"]
    torch.cuda.empty_cache()
    timed("lm_small", phase_lm_small)
    fa["launches"] = timed("lm_full", phase_lm_full)["sm90"]
    gc.collect()
    torch.cuda.empty_cache()
    timed("moe_small", phase_moe_small)
    moe = timed("moe_full", phase_moe_full)
    fa["launches_moe_prefill"] = moe["prefill_flash_launches_by_kernel"][
        "sm90"]
    sm["launches"] = moe["segment_matmul_launches_by_kernel"]["sm90"]
    check = timed("moe_check", phase_moe_check)
    fa_simt["launches"] = check["flash"]["simt"]
    sm_simt["launches"] = check["segment_matmul"]["simt"]
    timed("recsys_small", phase_recsys_small)
    eb["launches"] = timed("recsys_full", phase_recsys_full)
    gc.collect()
    torch.cuda.empty_cache()
    timed("train_small", phase_train_small)
    timed("gnn_train", phase_gnn_train)
    eb["launches_train"], eb["backward"] = timed("recsys_train",
                                                 phase_recsys_train)
    timed("roofline", phase_roofline)
    motif = timed("motif_gnn", phase_motif_gnn)
    for rec in recs:
        rec["launches_motif_gnn"] = motif[rec["name"]]
    free_card()
    small = timed("lm_train_small", phase_lm_train_small)
    learn = timed("lm_train_learn", phase_lm_train_learn)
    full = timed("lm_train_full", phase_lm_train_full)
    free_card()
    on_mesh = timed("lm_train_dist", phase_lm_train_dist)
    free_card()
    timed("gnn_train_dist", phase_gnn_train_dist)
    eb["launches_train_dist"], eb_dist = timed("recsys_train_dist",
                                               phase_recsys_train_dist)
    eb.update({f"train_dist_{k}": v for k, v in eb_dist.items()})
    timed("pipeline", phase_pipeline)
    # each kernel's launches on each LM-training path it serves: the sm90
    # flash kernel at full width and in lm100m, the sm90 grouped GEMM at
    # full width and in the bf16 MoE smoke configs, the CUDA-core kernels
    # in the smoke configs and the f32 check
    sm["lm_train_down_ms"] = full["kernels"]["segment_matmul"][
        "down; gate/up dX"]["ms"]
    for rec, key, k in (
            (fa, "flash", full["kernels"]["flash"]),
            (sm, "segment_matmul",
             full["kernels"]["segment_matmul"]["gate/up"])):
        rec.update(launches_lm_train=full["launches"][key]["sm90"],
                   **{f"lm_train_{x}": k[x] for x in (
                       "case", "max_abs_err", "ms", "plain_ms", "bound_ms",
                       "bound_by", "library_ms", "backward_ms")})
    # the same kernels on each rank of the (data=2, model=2) mesh, at one
    # rank's shapes, launches summed over the four ranks
    for rec, key, k in (
            (fa, "flash", on_mesh["kernels"]["flash"]),
            (sm, "segment_matmul",
             on_mesh["kernels"]["segment_matmul"]["gate/up"])):
        rec.update(launches_lm_train_dist=on_mesh["launches"][key],
                   **{f"lm_train_dist_{x}": k[x] for x in (
                       "case", "max_abs_err", "ms", "plain_ms", "bound_ms",
                       "bound_by", "library_ms")})
    fa["launches_lm_train_learn"] = learn["flash"]["sm90"]
    sm["launches_lm_train_small"] = small["segment_matmul"]["sm90"]
    for rec, key in ((fa_simt, "flash"), (sm_simt, "segment_matmul")):
        rec.update(launches_lm_train_small=small[key]["simt"],
                   launches_lm_train_check=full["check_launches"][key][
                       "simt"])
    recs += [fa, fa_simt, sm, sm_simt, eb]
    require(all(r["launches"] > 0 and r.get("launches_service", 1) > 0
                and r.get("launches_stream", 1) > 0
                and r.get("launches_gateway", 1) > 0
                and r.get("launches_mesh", 1) > 0
                and r.get("launches_train", 1) > 0
                and r.get("launches_motif_gnn", 1) > 0
                and r.get("launches_lm_train", 1) > 0
                and r.get("launches_lm_train_dist", 1) > 0
                and r.get("launches_train_dist", 1) > 0
                and r.get("launches_lm_train_learn", 1) > 0
                and r.get("launches_lm_train_small", 1) > 0
                and r.get("launches_lm_train_check", 1) > 0 for r in recs),
            "a kernel was launched no time on its path")
    emit({"phase": "total", "seconds": time.perf_counter() - T_START})
    emit({"phase_seconds": PHASE_SECONDS})
    emit({"kernels": recs})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    try:
        main()
    except BaseException:
        # where the time went up to the failure
        print(json.dumps({"phase_seconds": PHASE_SECONDS}), file=sys.stderr,
              flush=True)
        raise

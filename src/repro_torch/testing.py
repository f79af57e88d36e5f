"""Card against CPU on the smoke configs, on the same numpy weights, and
a host check of TIMEST witnesses.

Shared by the ``cuda``-marked tests (``tests/test_torch_cuda.py``), the
CPU tests and ``chip_smoke.py``.  Each run goes once through the plain versions of
the kernels (CPU tensors) and once through the CUDA kernels, f32
without TF32; ``compare`` holds the two runs' outputs within one
tolerance.

bf16 rounds differently on the two devices, and a one-ulp difference
flips a top-k choice at a near tie; then a whole expert differs for that
token.  ``PinnedRoutes`` therefore hands the CPU run's expert choices to
the card run (the card's gates and aux are its own router's at those
experts, so its router gradient stays its own) and asserts that wherever
the card's own top-k differs the router saw a near tie (``ROUTE_TIE``).
``MeshRoutes`` does the same for the ranks of a model mesh against one
process (each rank takes its rows of the one process's choices).
"""
from __future__ import annotations

import collections
import contextlib

import numpy as np
import torch

from .configs import get_smoke_config
from .kernels.embedding_bag.ops import embedding_bag
from .kernels.flash_attention.ops import flash_attention
from .kernels.flash_attention.ref import NEG_INF, visible
from .kernels.segment_matmul.ops import segment_matmul
from .models import moe, recsys, transformer
from .models.convert import (lm_from_numpy, numpy_params,
                             numpy_recsys_params, recsys_from_numpy,
                             tree_from_numpy)

def witness_edge_ids(g, motif, tree_edges, delta: int, entry: dict) -> list:
    """The graph edge ids of one witness entry (``engine.witness_entries``
    format: the tree's edges as ``(src, dst, t)`` in motif pi order),
    checked on the host against the motif.  Raises ``AssertionError``
    unless every edge is a real edge of ``g`` (id below ``g.live_m``),
    the vertex map is one-to-one and follows the motif's edges, the
    times rise strictly in pi order and span at most ``delta``."""
    ranks = sorted(tree_edges)
    edges = entry["edges"]
    assert len(edges) == len(ranks) and entry["cnt"] > 0, entry
    phi: dict = {}
    eids = []
    for r, (u, v, t) in zip(ranks, edges):
        x, y = motif.edges[r]
        for a, b in ((x, u), (y, v)):
            assert phi.setdefault(a, b) == b, f"vertex map breaks: {entry}"
        lo, hi = np.searchsorted(g.t, [t, t + 1])
        hit = [e for e in range(lo, hi) if g.src[e] == u and g.dst[e] == v]
        assert len(hit) == 1, f"({u}, {v}, {t}) is not one edge of the graph"
        eids.append(hit[0])
    assert len(set(phi.values())) == len(phi), f"vertex map not 1-1: {entry}"
    times = [t for _, _, t in edges]
    assert all(a < b for a, b in zip(times, times[1:])), f"order: {entry}"
    assert times[-1] - times[0] <= delta, f"delta: {entry}"
    assert max(eids) < g.live_m, f"a pad edge in {entry}"
    return eids


# a route of the card run may differ from the CPU run's only where the
# k-th and (k+1)-th router probabilities are this close (bf16 near ties)
ROUTE_TIE = 5e-3


def route_as(cfg, h2, w, experts, what: str):
    """``moe.route`` at the given ``experts`` ``[T, k]``: the gates and
    aux of this router's own probabilities there, and the number of
    tokens whose own top-k differs, each of which must sit at a near tie
    (``ROUTE_TIE``; ``what`` names the two runs in the error)."""
    probs = moe.router_probs(h2, w)
    own = torch.topk(probs, cfg.top_k, dim=-1).indices
    flip = (own.sort(-1).values != experts.sort(-1).values).any(-1)
    if bool(flip.any()):
        top = torch.topk(probs.detach()[flip], cfg.top_k + 1, -1).values
        gap = top[:, -2] - top[:, -1]
        assert bool((gap < ROUTE_TIE).all()), (
            f"{what} without a near tie (gaps {gap.tolist()})")
    gates, aux = moe.gates_and_aux(cfg, probs, experts)
    return gates, aux, int(flip.sum())


class PinnedRoutes:
    """Route every MoE layer of the card run as the CPU run routed it
    (while ``enabled``): the CPU run records its experts per ``route``
    call and the card run takes them in the same order (a training run's
    remat recomputes route again, in the same order on both devices).
    ``flips`` counts the tokens whose own top-k differed."""

    def __init__(self, enabled: bool = True):
        self.own = moe.route
        self.queue = collections.deque()
        self.enabled, self.flips = enabled, 0

    def __enter__(self):
        moe.route = self.route
        return self

    def __exit__(self, *exc):
        moe.route = self.own

    def route(self, cfg, h2, w):
        gates, experts, aux = self.own(cfg, h2, w)
        if not self.enabled:
            return gates, experts, aux
        if h2.device.type == "cpu":
            self.queue.append(experts)
            return gates, experts, aux
        e = self.queue.popleft().to(h2.device)
        gates, aux, flips = route_as(cfg, h2, w, e,
                                     "card routes differ from the CPU's")
        self.flips += flips
        return gates, e, aux


class MeshRoutes:
    """Route a model mesh's MoE layers as one process routed the same
    global batch.  Inside ``record()`` every ``route`` call keeps its
    experts ``[T, k]`` (on the host, in call order: a remat run routes
    each layer again in its backward, in the same order on both sides);
    inside ``pin(data_rank)`` each call takes, in order, this data
    rank's rows of the recorded experts (its tokens are a contiguous
    block of the global order), its gates and aux from its own router's
    probabilities at those experts.  A rank's own top-k may differ only
    at a near tie (``ROUTE_TIE``); ``flips`` counts the tokens where it
    did.  ``calls`` holds the recorded experts, to hand to the ranks."""

    def __init__(self, calls=None):
        self.calls = [] if calls is None else list(calls)
        self.flips = 0

    @contextlib.contextmanager
    def _routing(self, fn):
        own = moe.route
        moe.route = fn
        try:
            yield self
        finally:
            moe.route = own

    def record(self):
        own = moe.route

        def route(cfg, h2, w):
            gates, experts, aux = own(cfg, h2, w)
            self.calls.append(experts.cpu().numpy())
            return gates, experts, aux
        return self._routing(route)

    def pin(self, data_rank: int):
        queue = collections.deque(self.calls)

        def route(cfg, h2, w):
            T = h2.shape[0]
            want = torch.as_tensor(
                queue.popleft()[data_rank * T:(data_rank + 1) * T],
                device=h2.device).long()
            gates, aux, flips = route_as(
                cfg, h2, w, want, "mesh routes differ from one process's")
            self.flips += flips
            return gates, want, aux
        return self._routing(route)


def p_rounding_allowance(q, k, v, *, causal=True, window=0,
                         attn_softcap=0.0):
    """Per output element ``[B, Sq, Hq, D]``, how far two p's rounded to
    the other bf16 neighbour can move it: ``2 * 2^-7 * max_j (p_ij / l_i)
    * max_j |v_jd|`` (the max over the row's keys, resp. over all keys of
    the kv head).

    The sm90 flash kernel and ``flash_attention_ref(round_p=True)`` round
    the same p to bf16, but they sum ``q . k`` in different f32 orders, so
    a p within ~1e-6 of a bf16 rounding boundary may round up in one and
    down in the other: one bf16 step of p, at most 2^-7 of it, times its
    value row.  Such near-ties are rare, and where the softmax is flat
    (thousands of keys) every p is small, so this is ~0 there; where it
    is peaked (a few keys, or scores at a softcap) one flip moves an
    output by up to 2^-7 of the row's largest term."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    ok = visible(torch.arange(Sq, device=q.device),
                 torch.arange(Skv, device=q.device), causal, window)
    qg = q.reshape(B, Sq, Hkv, G, D)
    pmax = []
    for h in range(Hkv):
        s = torch.einsum("bqgd,bkd->bgqk", qg[:, :, h].float(),
                         k[:, :, h].float()) * (D ** -0.5)
        if attn_softcap:
            s = attn_softcap * torch.tanh(s / attn_softcap)
        s = torch.where(ok, s, NEG_INF)
        # the largest p / l of a row is exp(max - logsumexp)
        pmax.append(torch.exp(s.amax(-1) - torch.logsumexp(s, -1)))
        del s
    pmax = torch.stack(pmax, 1).reshape(B, Hq, Sq).transpose(1, 2)
    vmax = v.float().abs().amax(1).repeat_interleave(G, 1)  # [B, Hq, D]
    return 2 * 2.0 ** -7 * pmax[..., None] * vmax[:, None]


def _launches():
    return {fn.__name__: fn.launches
            for fn in (flash_attention, segment_matmul, embedding_bag)}


def _since(before):
    return {k: v - before[k] for k, v in _launches().items()}


def moe_lm_runs(arch: str, dtype, seed: int, device="cuda"):
    """Prefill 20 tokens (cache 24), then 3 decode steps, on the CPU and
    on ``device``; in bf16 with the CPU's routes pinned.  Returns, for the
    CPU run and the card run, the outputs (the 4 logits and the k cache,
    as f32 on the CPU) and the kernel launches; then the route flips."""
    cfg = get_smoke_config(arch)
    params = numpy_params(cfg, seed=seed)
    tokens = torch.as_tensor(
        np.random.default_rng(seed).integers(0, cfg.vocab, (2, 23)))
    runs, launches = [], []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with PinnedRoutes(enabled=dtype == torch.bfloat16) as pin:
            for dev in ("cpu", device):
                model = lm_from_numpy(cfg, params, device=dev)
                tok = tokens.to(dev)
                before = _launches()
                logits, cache = model.prefill(tok[:, :20], 24,
                                              compute_dtype=dtype)
                out = [logits]
                for s in range(20, 23):
                    logits, cache = model.decode_step(
                        cache, tok[:, s:s + 1], compute_dtype=dtype)
                    out.append(logits)
                launches.append(_since(before))
                runs.append([x.float().cpu()
                             for x in (*out, cache["k"])])
            assert not pin.queue, "the card run took fewer routes"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return runs, launches, pin.flips


def recsys_runs(dtype, seed: int, device="cuda"):
    """DCN-v2 smoke config: forward on a one-hot batch with ``-1`` pads
    and on a multi-hot batch (bag 4), then retrieval over 500
    candidates, on the CPU and on ``device``.  Returns, for the CPU run
    and the card run, the outputs (f32 on the CPU) and the kernel
    launches."""
    cfg = get_smoke_config("dcn-v2")
    params = numpy_recsys_params(cfg, seed=seed)
    r = np.random.default_rng(seed)
    sizes = np.array(cfg.table_sizes)
    batches = [dict(dense=r.standard_normal((64, cfg.n_dense)),
                    sparse=r.integers(-1, sizes, (64, cfg.n_sparse))),
               dict(dense=r.standard_normal((64, cfg.n_dense)),
                    sparse=r.integers(-1, sizes[:, None],
                                      (64, cfg.n_sparse, 4)))]
    cand = r.integers(0, cfg.table_sizes[0], 500)
    runs, launches = [], []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cpu", device):
            p = recsys_from_numpy(cfg, params, device=dev, dtype=dtype)
            before = _launches()
            out = [recsys.forward(cfg, p, {k: torch.as_tensor(v).to(dev)
                                           for k, v in b.items()},
                                  compute_dtype=dtype) for b in batches]
            b = batches[0]
            out.append(recsys.serve_retrieval(cfg, p, dict(
                dense=torch.as_tensor(b["dense"][:1]).to(dev),
                sparse=torch.as_tensor(b["sparse"][:1]).to(dev),
                cand_ids=torch.as_tensor(cand).to(dev)),
                compute_dtype=dtype))
            launches.append(_since(before))
            runs.append([x.float().cpu() for x in out])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return runs, launches


def compare(runs, tol: float) -> float:
    """Assert each output of the card run (``runs[1]``) within ``atol =
    rtol = tol`` of the CPU run's; return the largest difference."""
    cpu, card = runs
    for got, want in zip(card, cpu, strict=True):
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    return max(float((a - b).abs().max()) for a, b in zip(card, cpu))


# ---------------------------------------------------------------------------
# training: synthetic GNN batches and card-against-CPU train steps
# ---------------------------------------------------------------------------
def _pad_edges(snd, rcv, n_dst: int, multiple: int):
    """Append pad edges (sender 0, receiver ``n_dst``: out of range) up to
    a multiple of ``multiple``, as the reference's cells pad to 512."""
    e = len(snd)
    pad = -(-e // multiple) * multiple - e
    snd = np.concatenate([snd, np.zeros(pad, np.int64)])
    rcv = np.concatenate([rcv, np.full(pad, n_dst, np.int64)])
    return snd.astype(np.int32), rcv.astype(np.int32)


def gnn_full_batch(cfg, r, n: int, e: int, d_feat: int, n_classes: int,
                   multiple: int = 512) -> dict:
    """A full-graph batch in the layout of the reference's
    ``launch/specs.py`` GNN cells (numpy arrays): ``e`` random edges over
    ``n`` nodes padded to a multiple of ``multiple``; for GraphCast a mesh
    of ``max(16, n // mesh_ratio)`` nodes with ``2n`` grid-to-mesh (every
    grid node twice), ``8 n_mesh`` mesh and ``2n`` mesh-to-grid edges,
    each set padded, and an ``[n, n_vars]`` target."""
    feats = r.standard_normal((n, d_feat), dtype=np.float32)
    if cfg.kind != "graphcast":
        snd, rcv = _pad_edges(r.integers(0, n, e), r.integers(0, n, e), n,
                              multiple)
        return dict(feats=feats, senders=snd, receivers=rcv,
                    labels=r.integers(0, n_classes, n).astype(np.int32),
                    train_mask=(r.random(n) < 0.5).astype(np.float32))
    nm = max(16, n // cfg.mesh_ratio)
    grid2 = np.tile(np.arange(n), 2)
    batch = dict(feats=feats,
                 mesh_feats=r.standard_normal((nm, d_feat),
                                              dtype=np.float32),
                 target=r.standard_normal((n, cfg.n_vars),
                                          dtype=np.float32))
    for name, snd, rcv, n_dst in (
            ("g2m", grid2, r.integers(0, nm, 2 * n), nm),
            ("mesh", r.integers(0, nm, 8 * nm), r.integers(0, nm, 8 * nm),
             nm),
            ("m2g", r.integers(0, nm, 2 * n), grid2, n)):
        batch[f"{name}_senders"], batch[f"{name}_receivers"] = _pad_edges(
            snd, rcv, n_dst, multiple)
    return batch


def gnn_molecule_batch(r, B: int, n: int, e: int, d_feat: int,
                       n_classes: int, n_pad: int = 0) -> dict:
    """The ``molecule`` layout: ``B`` graphs of ``n`` nodes and ``e``
    edges, the last ``n_pad`` of each a pad edge (receiver ``n``)."""
    rcv = r.integers(0, n, (B, e))
    if n_pad:
        rcv[:, e - n_pad:] = n
    return dict(
        feats_batched=r.standard_normal((B, n, d_feat), dtype=np.float32),
        senders_b=r.integers(0, n, (B, e)).astype(np.int32),
        receivers_b=rcv.astype(np.int32),
        graph_label=r.standard_normal((B, n_classes), dtype=np.float32))


def gnn_block_batch(sampler, r, n_seed: int, fanouts, feats, labels) -> dict:
    """A GraphSAGE minibatch: ``n_seed`` distinct seeds drawn by ``r``,
    blocks sampled by ``sampler`` with ``r``, int32 edge ids."""
    seeds = r.choice(sampler.n, n_seed, replace=False)
    b = sampler.sample_blocks(seeds, tuple(fanouts), r, feats=feats,
                              labels=labels)
    return dict(feats=b["feats"], labels=b["labels"].astype(np.int32),
                blocks=[{k: v.astype(np.int32) for k, v in blk.items()}
                        for blk in b["blocks"]])


def to_torch(tree, device):
    """A nested dict / list of numpy arrays as tensors on ``device``."""
    from .train import pytree
    return pytree.tree_map(lambda a: torch.as_tensor(a).to(device), tree)


#: the smoke-size training cases: (name, arch, layout)
TRAIN_SMOKE = (("gat-cora", "gat-cora", "full"),
               ("gatedgcn", "gatedgcn", "molecule"),
               ("graphsage-reddit", "graphsage-reddit", "full"),
               ("graphsage-reddit-blocks", "graphsage-reddit", "blocks"),
               ("graphcast", "graphcast", "full"),
               ("dcn-v2", "dcn-v2", "recsys"))


def smoke_train_case(name: str, seed: int = 0):
    """``(cfg, loss_fn, numpy params, [numpy batch per step])`` of one
    ``TRAIN_SMOKE`` case: 3 batches, pad edges in every GNN layout."""
    from functools import partial

    from .graphs import NeighborSampler
    from .launch.train import synthetic_batch
    from .models import gnn
    from .models.convert import numpy_gnn_params
    _, arch, layout = next(c for c in TRAIN_SMOKE if c[0] == name)
    cfg = get_smoke_config(arch)
    r = np.random.default_rng(seed)
    if layout == "recsys":
        batches = [{k: v.numpy() for k, v in synthetic_batch(
            cfg, 16, 0, s, "cpu").items()} for s in range(3)]
        return (cfg, partial(recsys.train_loss, cfg),
                numpy_recsys_params(cfg, seed), batches)
    d_in, d_out = 6, (cfg.n_vars if cfg.kind == "graphcast" else 3)
    if layout == "full":
        batches = [gnn_full_batch(cfg, r, 24, 60, d_in, d_out, multiple=16)
                   for _ in range(3)]
    elif layout == "molecule":
        d_out = 1
        batches = [gnn_molecule_batch(r, 6, 7, 12, d_in, 1, n_pad=2)
                   for _ in range(3)]
    else:
        n = 80
        sampler = NeighborSampler(r.integers(0, n, 300),
                                  r.integers(0, n, 300), n)
        feats = r.standard_normal((n, d_in), dtype=np.float32)
        labels = r.integers(0, d_out, n)
        batches = [gnn_block_batch(sampler, r, 8, cfg.sample_sizes, feats,
                                   labels) for _ in range(3)]
    return (cfg, partial(gnn.train_loss, cfg),
            numpy_gnn_params(cfg, d_in, d_out, seed), batches)


def train_runs(name: str, device="cuda", seed: int = 0):
    """Three ``make_train_step`` steps of a ``TRAIN_SMOKE`` case on the CPU
    and on ``device`` from the same numpy weights and batches, f32
    parameters without TF32.  Returns, for the CPU run and the card run,
    the three losses and the final parameters (f32 on the CPU), then the
    kernel launches of each run."""
    from .train import pytree
    from .train.optimizer import AdamWConfig, adamw_init
    from .train.steps import make_train_step
    cfg, loss_fn, params, batches = smoke_train_case(name, seed)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    runs, launches = [], []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cpu", device):
            p = (recsys_from_numpy(cfg, params, device=dev)
                 if cfg.family == "recsys" else
                 tree_from_numpy(params, device=dev))
            opt = adamw_init(p)
            step = make_train_step(loss_fn, opt_cfg)
            before = _launches()
            losses = []
            for b in batches:
                p, opt, m = step(p, opt, to_torch(b, dev))
                losses.append(m["loss"].float().cpu())
            launches.append(_since(before))
            runs.append((torch.stack(losses),
                         [x.float().cpu() for x in pytree.leaves(p)]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return runs, launches


def compare_train(runs, tol: float) -> float:
    """Assert the card run's losses and final parameters (``runs[1]``)
    within ``rtol = tol`` and ``atol = tol * max |leaf|`` of the CPU
    run's; return the largest difference relative to its leaf's
    scale."""
    (cpu_loss, cpu_p), (card_loss, card_p) = runs
    worst = 0.0
    for got, want in zip([card_loss, *card_p], [cpu_loss, *cpu_p],
                         strict=True):
        scale = max(float(want.abs().max()), 1e-30)
        torch.testing.assert_close(got, want, rtol=tol, atol=tol * scale)
        worst = max(worst, float((got - want).abs().max()) / scale)
    return worst


def lm_batch(cfg, r, B: int = 2, S: int = 16) -> dict:
    """An LM batch of numpy arrays from ``r``: random tokens, their
    next-token labels and a mask with about a fifth zeros."""
    tok = r.integers(0, cfg.vocab, (B, S + 1))
    return dict(tokens=tok[:, :-1].astype(np.int32),
                labels=tok[:, 1:].astype(np.int32),
                mask=(r.random((B, S)) < 0.8).astype(np.float32))


def lm_train_runs(arch: str, dtype, device="cuda", seed: int = 0,
                  steps: int = 3):
    """An LM smoke config's ``train_loss`` in ``dtype`` on the CPU and on
    ``device`` from the same numpy tree and batches (f32 parameters, no
    TF32; in bf16 an MoE config's routes pinned to the CPU's): the first
    loss and gradient (``value_and_grad``), then ``steps`` AdamW steps.
    Returns, for the CPU run and the card run, a dict of ``loss``,
    ``grads`` (f32 on the CPU, jax's leaf order), ``losses``, ``params``
    and the kernel ``launches`` per step, then the route flips."""
    from functools import partial

    from .train import pytree
    from .train.optimizer import AdamWConfig, adamw_init
    from .train.steps import make_train_step, value_and_grad
    cfg = get_smoke_config(arch)
    params = numpy_params(cfg, seed=seed)
    r = np.random.default_rng(seed)
    batches = [lm_batch(cfg, r) for _ in range(steps)]
    loss_fn = partial(transformer.train_loss, cfg, compute_dtype=dtype)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    runs = []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with PinnedRoutes(enabled=cfg.is_moe
                          and dtype == torch.bfloat16) as pin:
            for dev in ("cpu", device):
                p = tree_from_numpy(params, device=dev)
                first = to_torch(batches[0], dev)
                loss, grads = value_and_grad(loss_fn)(p, first)
                opt, step = adamw_init(p), make_train_step(loss_fn, opt_cfg)
                before = _launches()
                losses = []
                for b in batches:
                    p, opt, m = step(p, opt, to_torch(b, dev))
                    losses.append(float(m["loss"]))
                launches = {k: v / steps for k, v in _since(before).items()}
                runs.append(dict(
                    loss=float(loss), losses=losses, launches=launches,
                    grads=[g.float().cpu() for g in pytree.leaves(grads)],
                    params=[x.float().cpu() for x in pytree.leaves(p)]))
            assert not pin.queue, "the card run took fewer routes"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return runs, pin.flips


def compare_lm_train(runs, tol: float) -> dict:
    """Assert the card run (``runs[1]``) within ``tol`` of the CPU run's:
    the first loss and the losses of the steps relatively, each gradient
    leaf and each final parameter leaf in relative L2; return the worst
    of each."""
    cpu, card = runs

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp(min=1e-30))
    worst = dict(
        loss=abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
        losses=max(abs(a - b) / abs(b)
                   for a, b in zip(card["losses"], cpu["losses"])),
        grads=max(rel(a, b) for a, b in zip(card["grads"], cpu["grads"],
                                            strict=True)),
        params=max(rel(a, b) for a, b in zip(card["params"], cpu["params"],
                                             strict=True)))
    assert all(v <= tol for v in worst.values()), (worst, tol)
    return worst

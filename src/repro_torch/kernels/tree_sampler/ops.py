"""Host side of the tree sampler: schedule, draws and the kernel wrapper.

``prepare_draws`` makes all randomness of a sample batch with the same
key schedule as the JAX reference sampler: ``keys = split(key, S + 2)``;
``keys[0]`` gives the window/center target ``x = randint(keys[0], K, W)``
and child ``c`` gets the two raw 64-bit draws that
``randint(keys[2 + c], ...)`` would split off internally, so the sampler
can replay the modular reduction against its in-kernel span.
``draws_at`` gives the same draws one sample index at a time, as the
CUDA kernel derives them from the chunk key.

``tree_sampler_keyed`` samples a chunk from its key, or one chunk for
each key of a ``[J, 2]`` stack (a tree cohort's seed streams, the
reference's ``vmap`` over its key stack): ``prepare_draws`` and the
plain torch version (``ref.py``) per stream for CPU tensors, one launch
of ``csrc/tree_sampler.cu`` (which draws its own bits) for all J
streams for CUDA tensors; on any other device, or on inputs the kernel
does not take, it raises.  ``tree_sampler_keyed.launches`` counts the
kernel launches.
``tree_sampler`` runs the plain version on given draws (CPU only).

Structural-fields-only contract: this module reads only the fields of
``core.spanning_tree.tree_signature`` (root, deps, topo_down,
num_edges), never ``edge_ids`` or non-tree motif edges.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ...core import rng
from ...core.bisect import bisect_iters
from ...core.spanning_tree import OUT, SpanningTree
from .ref import tree_sampler_ref

MAX_STEPS = 15


def build_schedule(tree: SpanningTree) -> tuple:
    """The static top-down child schedule, one tuple per dependency in
    sampling order: ``(parent, child, meet_end, alpha, beta, use_rev)``.

    ``use_rev`` picks ``rev_pair_id`` over ``pair_id`` for the Claim 4.8
    exclusion list (the parallel edges to the *other* endpoint).
    """
    steps = []
    for s in tree.topo_down:
        for d in tree.deps[s]:
            use_rev = d.meet_end != 0 if d.alpha == OUT else d.meet_end == 0
            steps.append((s, d.child, d.meet_end, d.alpha, d.beta,
                          int(use_rev)))
    return tuple(steps)


def prepare_draws(tree: SpanningTree, wts, key: torch.Tensor, K: int):
    """All randomness for K samples, on the device of ``key``.

    Returns ``(x [K], uhi [K, S], ulo [K, S])`` int64; ``uhi``/``ulo``
    hold uint64 bit patterns and the root's column is zero.
    """
    return _prepare_draws(tree.root, tree.num_edges, wts, key, K)


def _prepare_draws(root: int, S: int, wts, key: torch.Tensor, K: int):
    keys = rng.split(key, S + 2)
    x = rng.randint(keys[0], K, wts.W_total.clamp(min=1))
    # one threefry pass for every child's (hi, lo) pair
    draws = rng.bits(rng.split(keys[2:], 2), K)          # [S, 2, K]
    draws[root] = 0
    return x, draws[:, 0].T.contiguous(), draws[:, 1].T.contiguous()


def draws_at(tree: SpanningTree, wts, key: torch.Tensor, idx: torch.Tensor):
    """The rows ``idx`` (int64 ``[N]``) of ``prepare_draws(tree, wts, key,
    K)``, each computed from its own sample index, as the CUDA kernel
    derives them.

    The schedule: the chunk's keys ``keys = split(key, S + 2)`` and
    their splits ``split(keys[0], 2)`` and ``split(keys[2 + c], 2)`` are
    made once (per block, in the kernel); sample ``k`` then takes
    ``x = randint_from_bits(bits(kx0)[k], bits(kx1)[k], max(W, 1))`` and,
    for child ``c``, ``uhi = bits(kc0)[k]``, ``ulo = bits(kc1)[k]``,
    where ``bits(key)[k]`` is the threefry block at counter ``k``
    (``rng.bits_at``).  Returns ``(x [N], uhi [N, S], ulo [N, S])``.
    """
    S = tree.num_edges
    keys = rng.split(key, S + 2)
    kx = rng.split(keys[0], 2)
    span = wts.W_total.clamp(min=1).expand(idx.shape)
    x = rng.randint_from_bits(rng.bits_at(kx[0], idx),
                              rng.bits_at(kx[1], idx), span)
    draws = rng.bits_at(rng.split(keys[2:], 2), idx)     # [S, 2, N]
    draws[tree.root] = 0
    return x, draws[:, 0].T.contiguous(), draws[:, 1].T.contiguous()


class _Step(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int64) for n in
                ("parent", "child", "meet_end", "alpha", "beta", "use_rev")]


_GRAPH = ("t", "src", "dst", "out_ptr", "in_ptr", "out_t", "in_t",
          "out_edge", "in_edge", "pair_pos_out", "pair_pos_in", "pair_ptr",
          "pair_t", "pair_id", "rev_pair_id")
_WEIGHTS = ("ps_win", "win_lo", "win_mid", "win_hi", "ps_acc_own",
            "ps_acc_prev", "ps_pair_own", "ps_pair_prev")
_OUT = ("edges", "window")
_SCALARS = ("K", "m", "S", "q", "root", "use_c2", "it", "delta", "wd",
            "n_steps", "J")
MAX_STREAMS = 65535      # the grid's y extent
_I32 = ("src", "dst", "out_edge", "in_edge", "pair_id", "rev_pair_id")


class _SamplerArgs(ctypes.Structure):
    """Mirror of ``SamplerArgs`` in ``csrc/tree_sampler.cu``."""

    _fields_ = ([(n, ctypes.c_void_p)
                 for n in _GRAPH + _WEIGHTS + ("W_total", "key") + _OUT]
                + [(n, ctypes.c_int64) for n in _SCALARS]
                + [("steps", _Step * MAX_STEPS)])


def _check_inputs(schedule, S, dev, wts, device, extra):
    m = dev["t"].shape[0]
    tensors = dict({n: dev[n] for n in _GRAPH},
                   **{n: getattr(wts, n) for n in _WEIGHTS}, **extra)
    for name, v in tensors.items():
        want = torch.int32 if name in _I32 else torch.int64
        if v.device != device or v.dtype != want:
            raise ValueError(f"tree_sampler: {name} must be {want} on "
                             f"{device}, got {v.dtype} on {v.device}")
    if wts.ps_acc_own.shape != (S, m + 1):
        raise ValueError("tree_sampler: prefixes must be [S, m+1]")
    # a padded snapshot's window arrays hold q_pad >= q slots; the
    # searches stay inside the real [0, q)
    if not (1 <= wts.q <= wts.q_pad and all(
            getattr(wts, n).shape == (wts.q_pad,)
            for n in ("win_lo", "win_mid", "win_hi"))):
        raise ValueError("tree_sampler: window arrays must hold "
                         "q_pad >= q >= 1 slots")
    if len(schedule) > MAX_STEPS or len(schedule) != S - 1:
        raise ValueError(f"tree_sampler: a tree of {S} edges needs "
                         f"{S - 1} <= {MAX_STEPS} schedule steps")


def tree_sampler(schedule: tuple, root: int, S: int, dev: dict, wts, x,
                 uhi, ulo):
    """Alg. 3 for ``K = len(x)`` samples on given draws (``prepare_draws``)
    with the plain version; returns ``(edges [K, S], window [K])`` int64.

    CPU tensors only: on the card the kernel draws its own bits
    (``tree_sampler_keyed``)."""
    K = x.shape[0]
    _check_inputs(schedule, S, dev, wts, x.device,
                  dict(x=x, uhi=uhi, ulo=ulo))
    if uhi.shape != (K, S) or ulo.shape != (K, S):
        raise ValueError("tree_sampler: uhi/ulo must be [K, S]")
    if x.device.type != "cpu":
        raise ValueError(f"tree_sampler: no kernel for device {x.device} "
                         "(on the card the kernel draws its own bits: "
                         "tree_sampler_keyed)")
    return tree_sampler_ref(schedule, root, S, dev, wts, x, uhi, ulo)


def tree_sampler_keyed(schedule: tuple, root: int, S: int, dev: dict, wts,
                       key: torch.Tensor, K: int):
    """Alg. 3 for K samples drawn from the chunk key ``key`` (int64, on
    the graph's device): ``[2]`` gives ``(edges [K, S], window [K])``,
    a stack ``[J, 2]`` of J streams' keys gives ``(edges [J, K, S],
    window [J, K])`` whose stream ``i`` is the output for ``key[i]``
    alone.

    CPU tensors: ``prepare_draws`` then the plain version, per stream.
    CUDA tensors: one launch of the kernel for all streams, which draws
    the same bits itself.
    """
    device = key.device
    _check_inputs(schedule, S, dev, wts, device,
                  dict(W_total=wts.W_total, key=key))
    if key.shape[-1:] != (2,) or key.dim() > 2 or K < 0:
        raise ValueError("tree_sampler: key must be [2] or [J, 2] and "
                         "K >= 0")
    keys = key.reshape(-1, 2)
    J = keys.shape[0]
    if not 1 <= J <= MAX_STREAMS:
        raise ValueError(f"tree_sampler: {J} streams, want 1 to "
                         f"{MAX_STREAMS}")
    if device.type == "cpu":
        outs = [tree_sampler_ref(schedule, root, S, dev, wts,
                                 *_prepare_draws(root, S, wts, kj, K))
                for kj in keys]
        edges = torch.stack([e for e, _ in outs])
        window = torch.stack([w for _, w in outs])
        return (edges, window) if key.dim() == 2 else (edges[0], window[0])
    if device.type != "cuda":
        raise ValueError(f"tree_sampler: no kernel for device {device}")
    m = dev["t"].shape[0]
    edges = torch.empty((*key.shape[:-1], K, S), dtype=torch.int64,
                        device=device)
    window = torch.empty((*key.shape[:-1], K), dtype=torch.int64,
                         device=device)
    if K == 0:
        return edges, window
    keep = dict({n: dev[n].contiguous() for n in _GRAPH},
                **{n: getattr(wts, n).contiguous() for n in _WEIGHTS},
                W_total=wts.W_total, key=keys.contiguous(), edges=edges,
                window=window)
    args = _SamplerArgs(
        **{n: v.data_ptr() for n, v in keep.items()},
        K=K, m=m, S=S, q=wts.q, root=root, use_c2=int(wts.use_c2),
        it=bisect_iters(m), delta=wts.delta, wd=wts.wd,
        n_steps=len(schedule), J=J)
    for i, step in enumerate(schedule):
        args.steps[i] = _Step(*step)
    fn = _build.library("tree_sampler").tree_sampler_launch
    fn.argtypes = [ctypes.POINTER(_SamplerArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        rc = fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "tree_sampler")
    tree_sampler_keyed.launches += 1
    return edges, window


tree_sampler_keyed.launches = 0

"""Wrapper of the dep-sum kernel (``csrc/interval_weight.cu``).

``dep_sum`` computes one whole Claim 4.9 dep-sum of the weight DP: its
plain torch version (``ref.dep_sum_ref``) for CPU tensors; for CUDA
tensors one launch of the CUDA kernel, which builds every edge's queries
itself and stores the results in meet-vertex order, then one gather back
to edge order; on any other device it raises.  ``dep_sum.launches``
counts the kernel launches.

``interval_weight`` answers explicit queries with the plain version: it
takes CPU tensors only, since on the card the queries never exist as
arrays.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ...core.spanning_tree import BEFORE, OUT, Dependency
from .ref import dep_sum_ref, interval_weight_ref, pair_ids


def _check_inputs(csr_t, ps_own, ps_prev, queries):
    m = csr_t.shape[0]
    dev = csr_t.device
    for name, x, n in (("csr_t", csr_t, m), ("ps_own", ps_own, m + 1),
                       ("ps_prev", ps_prev, m + 1)):
        if x.dtype != torch.int64 or x.dim() != 1 or x.shape[0] != n:
            raise ValueError(f"interval_weight: {name} must be int64 [{n}], "
                             f"got {x.dtype} {tuple(x.shape)}")
    Q = queries[0].shape
    for x in (csr_t, ps_own, ps_prev, *queries):
        if x.device != dev:
            raise ValueError("interval_weight: inputs on different devices")
    for x in queries:
        if x.dtype != torch.int64 or x.shape != Q or x.dim() != 1:
            raise ValueError("interval_weight: queries must be int64 [Q] "
                             "of one length")


def interval_weight(csr_t, ps_own, ps_prev, p0, p1, tlo, thi, brk):
    """Batched two-piece interval weight sums of explicit queries
    (``ref.interval_weight_ref``), on CPU tensors."""
    queries = (p0, p1, tlo, thi, brk)
    _check_inputs(csr_t, ps_own, ps_prev, queries)
    device = csr_t.device
    if device.type != "cpu":
        raise ValueError(f"interval_weight: no kernel for device {device} "
                         "(on the card, dep_sum builds the queries inside "
                         "its kernel)")
    return interval_weight_ref(csr_t, ps_own, ps_prev, *queries)


class _DepSumArgs(ctypes.Structure):
    """Mirror of ``DepSumArgs`` in ``csrc/interval_weight.cu``."""

    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("perm_t", "meet", "pid", "ptr", "csr_t", "pso", "psp",
                  "pair_ptr", "pair_t", "ppo", "ppp", "out")]
                + [(n, ctypes.c_int64) for n in
                   ("m", "delta", "wd", "prev", "before", "use_c2")])


def kernel_arrays(dev: dict, d: Dependency) -> dict:
    """The graph arrays the kernel reads for dependency ``d``, and
    ``pos``, which puts its result back in edge order.

    Thread ``i`` takes edge ``perm[i]``, where ``perm`` is the CSR that
    groups edges by their meet vertex (the out-CSR when ``meet_end ==
    0``, the in-CSR when 1); ``perm_t``, ``meet`` and ``pid`` are that
    edge's time, meet vertex and Claim 4.8 pair list, gathered into the
    same order so the kernel reads them coalesced, and the kernel stores
    edge ``perm[i]``'s result at ``i``; ``pos`` (``pos[perm[i]] = i``)
    gathers it back.  ``ptr`` and ``csr_t`` are the alpha-CSR searched.
    The arrays depend on ``d``'s ``meet_end`` and ``alpha`` only, so a
    caller gathers them once for all dependencies and windows that
    share those.
    """
    grp = "out" if d.meet_end == 0 else "in"
    alpha = "out" if d.alpha == OUT else "in"
    perm = dev[f"{grp}_edge"].long()
    pos = torch.empty_like(perm)
    pos[perm] = torch.arange(perm.shape[0], device=perm.device)
    return dict(perm_t=dev[f"{grp}_t"],
                meet=dev["src" if d.meet_end == 0 else "dst"][perm],
                pid=pair_ids(dev, d)[perm], ptr=dev[f"{alpha}_ptr"],
                csr_t=dev[f"{alpha}_t"], pair_ptr=dev["pair_ptr"],
                pair_t=dev["pair_t"], pos=pos)


_ARRAYS = ("perm_t", "meet", "pid", "ptr", "csr_t", "pair_ptr", "pair_t",
           "pos")
_I32 = ("meet", "pid")


def _check_dep_sum(dev, arrays, window, ps_csr, ps_pair):
    m = dev["t"].shape[0]
    device = dev["t"].device
    if window not in ("own", "prev"):
        raise ValueError(f"dep_sum: window must be 'own' or 'prev', got "
                         f"{window!r}")
    if sorted(arrays) != sorted(_ARRAYS):
        raise ValueError(f"dep_sum: arrays must hold {_ARRAYS}, got "
                         f"{tuple(arrays)}")
    for name, x in arrays.items():
        want = torch.int32 if name in _I32 else torch.int64
        if x.dtype != want or x.device != device:
            raise ValueError(f"dep_sum: {name} must be {want} on {device}, "
                             f"got {x.dtype} on {x.device}")
        if name not in ("ptr", "pair_ptr") and x.shape != (m,):
            raise ValueError(f"dep_sum: {name} must be [{m}], got "
                             f"{tuple(x.shape)}")
    for x in (*ps_csr, *(ps_pair or ())):
        if x.dtype != torch.int64 or x.shape != (m + 1,):
            raise ValueError(f"dep_sum: prefixes must be int64 [{m + 1}], "
                             f"got {x.dtype} {tuple(x.shape)}")
        if x.device != device:
            raise ValueError("dep_sum: prefixes and graph on different "
                             "devices")


def dep_sum(dev: dict, d: Dependency, window: str, delta: int, wd: int,
            ps_csr: tuple, ps_pair: tuple | None = None,
            arrays: dict | None = None) -> torch.Tensor:
    """Claim 4.9's dep-sum of every edge under dependency ``d`` and
    ``window`` (``"own"`` or ``"prev"``), minus the Claim 4.8 exclusion
    when ``ps_pair`` is given (C2 on); ``[m]`` int64 in edge order.

    ``ps_csr = (own, prev)``: the child's exclusive prefixes ``[m+1]`` in
    its alpha-CSR order; ``ps_pair``: the same in pair-CSR order.
    ``arrays``: ``kernel_arrays(dev, d)``, gathered here when not given.
    """
    if arrays is None:
        arrays = kernel_arrays(dev, d)
    _check_dep_sum(dev, arrays, window, ps_csr, ps_pair)
    device = dev["t"].device
    if device.type == "cpu":
        return dep_sum_ref(dev, d, window, delta, wd, ps_csr, ps_pair)
    if device.type != "cuda":
        raise ValueError(f"dep_sum: no kernel for device {device}")
    m = dev["t"].shape[0]
    out = torch.empty(m, dtype=torch.int64, device=device)
    pso, psp = ps_csr
    ppo, ppp = ps_pair if ps_pair is not None else ps_csr  # unread: C2 off
    keep = {n: v for n, v in arrays.items() if n != "pos"}
    keep.update(pso=pso, psp=psp, ppo=ppo, ppp=ppp)
    keep = {n: v.contiguous() for n, v in keep.items()}
    args = _DepSumArgs(**{n: v.data_ptr() for n, v in keep.items()},
                       out=out.data_ptr(), m=m, delta=int(delta),
                       wd=int(wd), prev=int(window == "prev"),
                       before=int(d.beta == BEFORE),
                       use_c2=int(ps_pair is not None))
    fn = _build.library("interval_weight").dep_sum_launch
    fn.argtypes = [ctypes.POINTER(_DepSumArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        rc = fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "interval_weight")
    dep_sum.launches += 1
    return out[arrays["pos"]]


dep_sum.launches = 0

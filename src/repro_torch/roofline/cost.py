"""Per-rank cost of one step, counted op by op on meta tensors (the
port's counterpart of ``repro.roofline.hlo_cost``).

The reference walks the optimized HLO of a compiled step.  Torch
compiles nothing ahead, so the port runs the step itself: one rank's
``fn`` on meta tensors of that rank's local shapes
(``dist.sharding.local_shape``) under ``counting()``, a
``TorchDispatchMode`` that sees every aten op the step dispatches,
forward and backward.  Per op it counts:

* **flops** -- by the formulas of ``torch.utils.flop_counter`` (matrix
  products, convolutions, attention), and ``2 n`` a multiply-add for the
  products it has no formula for (``mv``, ``addmv``, ``dot``), split by
  the dtype of the op's first tensor input.  Elementwise ops count no
  flops (as ``flop_counter``), where the reference's HLO walk counts one
  an element: a cell whose ``model_flops`` counts elementwise edge work
  (GAT's attention logits) can read a useful ratio above 1;
* **bytes** -- the bytes of every tensor input and output of an op that
  materialises.  Views and metadata ops (``OpOverload.is_view``, the
  ``empty`` factories, ``_unsafe_view``) are free: the counterpart of
  the reference's ``_FREE``.  As the reference's unfused count
  (``hlo_cost_raw``), every op is taken to read its inputs from and
  write its outputs to memory;
* **collective bytes by kind** -- the ``(kind, operand bytes)`` that
  ``dist.collectives`` reports for each collective on a layout group
  (``LAYOUT_SINKS``), the reference's convention of summing operand
  sizes (``roofline/analysis.py:parse_collectives``); the operand and
  result bytes also count as memory traffic, as the reference's walk
  counts them.

The hand-written kernels (flash attention, the grouped GEMM, the bag
sum) have no aten op: on meta tensors inside ``counting()`` each
wrapper returns an output of the right shape and dtype and reports its
work here (``kernel``) by the formulas of its bound in PERF.md (the
attended (query, key) pairs, the special-function ops of the softmax
and the softcap, the GEMM's and the bag sum's products and bytes).  The
flash backward reports its work by formula the same way
(``kernels.flash_attention.ops.flash_attention_grads_meta``).  Outside
``counting()`` a meta tensor still raises in every wrapper.

Eager torch runs every iteration of every loop (layers, microbatches,
query blocks), so the reference's trip-count multiplication of while
bodies has no counterpart in what runs: each iteration's ops are
counted as they run.  One loop is counted from its first iteration
(``alike``): ``roofline.analysis.analyze`` wraps a train step's
``grads_of``, so the microbatches of a gradient accumulation, alike in
shape, run once and are counted again from the first.  On meta tensors
nothing depends on values, so the same shapes dispatch the same ops:
counting them again is what the reference's multiplication does.
Bytes saved for backward are tracked through
``torch.autograd.graph.saved_tensors_hooks``: the peak of what is held
at once, distinct storages, the step's arguments left out.
"""
from __future__ import annotations

import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.flop_counter import flop_registry

from ..dist import collectives as coll

_aten = torch.ops.aten
_FREE = {_aten.empty.memory_format, _aten.empty_strided.default,
         _aten.empty_like.default, _aten.new_empty.default,
         _aten.new_empty_strided.default, _aten._unsafe_view.default,
         _aten.lift_fresh.default}


def _mv_flops(mat, vec, *args, out_val=None, **kwargs) -> int:
    return 2 * mat.numel()


# products ``torch.utils.flop_counter`` has no formula for
_MORE_FLOPS = {
    _aten.mv: _mv_flops,
    _aten.addmv: lambda bias, mat, vec, *a, out_val=None, **k: 2 * mat.numel(),
    _aten.dot: lambda a, b, *r, out_val=None, **k: 2 * a.numel(),
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@dataclass
class Cost:
    """One rank's counted work: flops by dtype (``"sfu"``: the
    special-function ops of the flash kernel), memory bytes, collective
    bytes by kind, and the same per op or kernel name (``by_op``)."""

    flops_by_dtype: dict = field(default_factory=dict)
    bytes: float = 0.0
    coll_by_kind: dict = field(default_factory=dict)
    by_op: dict = field(default_factory=dict)
    ops: int = 0
    saved_peak_bytes: int = 0
    largest_transient_bytes: int = 0
    alike: dict = field(default_factory=dict, repr=False)

    @property
    def flops(self) -> float:
        """Floating-point operations over every dtype (SFU ops left out:
        they are the exponentials and reciprocals of the same work)."""
        return float(sum(v for k, v in self.flops_by_dtype.items()
                         if k != "sfu"))

    @property
    def coll_bytes(self) -> float:
        return float(sum(v["bytes"] for v in self.coll_by_kind.values()))

    def add(self, name: str, flops: float = 0.0, dtype: str = "",
            nbytes: float = 0.0) -> None:
        self.ops += 1
        if flops:
            self.flops_by_dtype[dtype] = (self.flops_by_dtype.get(dtype, 0.0)
                                          + flops)
        self.bytes += nbytes
        row = self.by_op.setdefault(name, dict(count=0, flops=0.0,
                                               bytes=0.0))
        row["count"] += 1
        row["flops"] += flops
        row["bytes"] += nbytes

    def _state(self) -> tuple:
        return (dict(self.flops_by_dtype), self.bytes,
                {k: dict(v) for k, v in self.coll_by_kind.items()},
                {k: dict(v) for k, v in self.by_op.items()}, self.ops)

    def _since(self, before: tuple) -> tuple:
        """What was counted after ``before`` (a ``_state()``)."""
        flops, nbytes, coll0, by_op0, ops = before

        def diff(now, then):
            return {k: {f: v - then.get(k, {}).get(f, 0) for f, v in
                        row.items()} for k, row in now.items()
                    if row != then.get(k)}
        return ({k: v - flops.get(k, 0.0) for k, v in
                 self.flops_by_dtype.items() if v != flops.get(k, 0.0)},
                self.bytes - nbytes, diff(self.coll_by_kind, coll0),
                diff(self.by_op, by_op0), self.ops - ops)

    def _add_again(self, delta: tuple) -> None:
        flops, nbytes, coll_rows, op_rows, ops = delta
        for k, v in flops.items():
            self.flops_by_dtype[k] = self.flops_by_dtype.get(k, 0.0) + v
        self.bytes += nbytes
        self.ops += ops
        for table, rows in ((self.coll_by_kind, coll_rows),
                            (self.by_op, op_rows)):
            for k, row in rows.items():
                mine = table.setdefault(k, {f: 0 for f in row})
                for f, v in row.items():
                    mine[f] += v

    def add_collective(self, kind: str, operand: int, result: int) -> None:
        e = self.coll_by_kind.setdefault(kind, dict(bytes=0.0, count=0))
        e["bytes"] += operand
        e["count"] += 1
        self.add(kind, nbytes=operand + result)


class _Counter(TorchDispatchMode):
    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func in _FREE:
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        flops, dtype = 0.0, ""
        formula = (flop_registry.get(func.overloadpacket)
                   or _MORE_FLOPS.get(func.overloadpacket))
        if formula is not None:
            flops = float(formula(*args, **kwargs, out_val=out))
            dtype = dtype_name(ins[0].dtype) if ins else ""
        out_bytes = sum(_nbytes(t) for t in outs)
        self.cost.largest_transient_bytes = max(
            self.cost.largest_transient_bytes, out_bytes)
        self.cost.add(str(func.overloadpacket).removeprefix("aten."), flops,
                      dtype, sum(_nbytes(t) for t in ins) + out_bytes)
        return out


_ACTIVE: list = []


def active() -> Cost | None:
    """The ``Cost`` of the innermost ``counting()`` region, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def kernel(name: str, *, flops: float, dtype: torch.dtype, nbytes: float,
           sfu: float = 0.0) -> None:
    """Report one launch of a hand-written kernel on meta tensors (its
    wrapper's shape-only path, taken only inside ``counting()``)."""
    cost = active()
    if cost is None:
        raise RuntimeError(f"{name}: no counting() region")
    cost.add(name, flops, dtype_name(dtype), nbytes)
    if sfu:
        cost.flops_by_dtype["sfu"] = cost.flops_by_dtype.get("sfu",
                                                             0.0) + sfu


def _shapes(tree) -> tuple:
    return tuple((tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor)
                 else t for t in tree_flatten(tree)[0])


def alike(tag, fn, *args):
    """``fn(*args)``.  Inside ``counting()`` on meta tensors, a call whose
    ``tag`` and argument shapes were seen before runs nothing: it counts
    the first such call's ops, kernels and collectives again and returns
    fresh meta tensors of its outputs' shapes (meta tensors hold no
    values, so the same shapes dispatch the same work)."""
    cost = active()
    if cost is None:
        return fn(*args)
    leaves = [t for t in tree_flatten(args)[0] if isinstance(t, torch.Tensor)]
    if not leaves or not all(t.is_meta for t in leaves):
        return fn(*args)
    key = (tag, _shapes(args))
    seen = cost.alike.get(key)
    if seen is None:
        before = cost._state()
        out = fn(*args)
        cost.alike[key] = (cost._since(before), out)
        return out
    delta, out = seen
    cost._add_again(delta)
    flat, spec = tree_flatten(out)
    return tree_unflatten([torch.empty_like(t) if isinstance(t, torch.Tensor)
                           else t for t in flat], spec)


class _Saved:
    """Holds one tensor autograd saved; its storage counts as saved
    until the last holder of it is freed."""

    __slots__ = ("t", "__weakref__")

    def __init__(self, t):
        self.t = t


@contextmanager
def counting(exclude=()):
    """Count every op, kernel and layout collective inside the region
    into the ``Cost`` it yields.  Tensors in ``exclude`` (the step's
    arguments) are not counted as saved for backward."""
    cost = Cost()
    skip = {t.untyped_storage()._cdata for t in exclude}
    live: dict = {}
    held = [0]

    def release(key, size):
        live[key] -= 1
        if not live[key]:
            del live[key]
            held[0] -= size

    def pack(t):
        holder = _Saved(t)
        key = t.untyped_storage()._cdata
        if key not in skip:
            if key not in live:
                live[key] = 0
                held[0] += t.untyped_storage().nbytes()
                cost.saved_peak_bytes = max(cost.saved_peak_bytes, held[0])
            live[key] += 1
            weakref.finalize(holder, release, key,
                             t.untyped_storage().nbytes())
        return holder

    def unpack(holder):
        return holder.t

    _ACTIVE.append(cost)
    coll.LAYOUT_SINKS.append(cost.add_collective)
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, unpack), \
                _Counter(cost):
            yield cost
    finally:
        coll.LAYOUT_SINKS.remove(cost.add_collective)
        _ACTIVE.remove(cost)

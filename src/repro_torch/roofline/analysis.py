"""Three-term roofline of one rank's step on an H100 (the port of
``repro.roofline.analysis``):

    compute     = sum over dtypes of flops / that dtype's peak
    memory      = bytes / HBM bandwidth
    collective  = collective bytes / NVLink bandwidth (one direction)

The terms are one rank's: ``roofline.cost`` counts one rank's step on
meta tensors of its local shapes, the counterpart of the reference's
per-device ``cost_analysis`` after GSPMD partitioning, so no "chips x"
division is applied.  Collective bytes are the operand sizes of every
collective the step calls on its layout groups (the reference's
convention, ``parse_collectives``).

Hardware constants (NVIDIA H100 SXM data sheet, dense, at its 700 W
limit): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 on the CUDA
cores (the port's f32 contract excludes TF32), 3.35 TB/s HBM3, 450 GB/s
NVLink each way, and the special-function units' 16 results a clock on
each of 132 SMs at 1.83 GHz (the flash kernel's exponentials).  The v5e
constants of the reference do not apply.  ``memory`` stands in for
XLA's ``memory_analysis()``: the rank's arguments, its outputs, the
bytes saved for backward at their peak plus the largest op output, and
the donated arguments.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field

import torch

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "sfu": 132 * 16 * 1.83e9}
OTHER_FLOPS = 67e12          # any other dtype: the CUDA cores' rate
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # bytes/s per card, one direction


@dataclass
class CollectiveStats:
    total_bytes: int = 0
    by_kind: dict = field(default_factory=dict)
    count: int = 0

    def add(self, kind: str, nbytes: int) -> None:
        self.total_bytes += nbytes
        self.count += 1
        k = self.by_kind.setdefault(kind, dict(bytes=0, count=0))
        k["bytes"] += nbytes
        k["count"] += 1


@dataclass
class Roofline:
    flops: float                 # per device
    bytes_hbm: float             # per device
    coll_bytes: float            # per device
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float           # global "useful" flops
    useful_ratio: float          # model_flops / global counted flops
    step_s: float                # max of the three terms
    roofline_frac: float         # compute_s / step_s (how compute-bound)

    def to_dict(self):
        return asdict(self)


def compute_seconds(flops_by_dtype: dict) -> float:
    """Each dtype's flops over its peak, summed."""
    return sum(f / PEAK_FLOPS.get(d, OTHER_FLOPS)
               for d, f in flops_by_dtype.items())


def roofline_from(cost: dict, coll: CollectiveStats, n_devices: int,
                  model_flops: float) -> Roofline:
    """``cost``: ``flops`` (floating-point ops, per device),
    ``flops_by_dtype`` (default: all bf16), ``bytes accessed``."""
    flops = float(cost.get("flops", 0.0))
    by_dtype = cost.get("flops_by_dtype", {"bfloat16": flops})
    nbytes = float(cost.get("bytes accessed", 0.0))
    cb = float(coll.total_bytes)
    compute_s = compute_seconds(by_dtype)
    memory_s = nbytes / HBM_BW
    collective_s = cb / LINK_BW
    terms = dict(compute=compute_s, memory=memory_s, collective=collective_s)
    bottleneck = max(terms, key=terms.get)
    step_s = max(terms.values())
    global_flops = flops * n_devices
    return Roofline(
        flops=flops, bytes_hbm=nbytes, coll_bytes=cb,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck, model_flops=model_flops,
        useful_ratio=model_flops / global_flops if global_flops else 0.0,
        step_s=step_s,
        roofline_frac=compute_s / step_s if step_s else 0.0)


def local_args(cell, mesh) -> tuple:
    """Meta tensors of this rank's pieces of the cell's arguments (the
    arguments themselves where the cell runs whole)."""
    from ..dist.sharding import local_shape
    from ..train import pytree
    if cell.runs_whole:
        return tuple(cell.args)

    def piece(x, spec):
        return torch.empty(local_shape(x.shape, spec, mesh), dtype=x.dtype,
                           device="meta")
    return tuple(pytree.tree_map(piece, a, s)
                 for a, s in zip(cell.args, cell.in_shardings, strict=True))


def _bytes(tree) -> int:
    from torch.utils._pytree import tree_flatten
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def analyze(cell, mesh):
    """Run one rank's step of ``cell`` on meta tensors under the counter:
    ``(Roofline, CollectiveStats, memory dict, Cost)``.  A train step's
    microbatches run once and count ``accum`` times (``cost.alike``)."""
    from ..train import pytree
    from .cost import alike, counting
    args = local_args(cell, mesh)
    grads_of = getattr(cell.fn, "grads_of", None)     # a train step's
    if grads_of is not None:                          # microbatch body
        cell.fn.grads_of = lambda *a: alike("microbatch", grads_of, *a)
    try:
        with counting(pytree.leaves(list(args))) as c:
            out = cell.fn(*args)
    finally:
        if grads_of is not None:
            cell.fn.grads_of = grads_of
    coll = CollectiveStats(
        total_bytes=int(c.coll_bytes),
        by_kind={k: dict(bytes=int(v["bytes"]), count=int(v["count"]))
                 for k, v in c.coll_by_kind.items()},
        count=int(sum(v["count"] for v in c.coll_by_kind.values())))
    memd = dict(
        argument_bytes=_bytes(list(args)),
        output_bytes=_bytes(out),
        temp_bytes=int(c.saved_peak_bytes + c.largest_transient_bytes),
        alias_bytes=_bytes([args[i] for i in cell.donate_argnums]),
        saved_bytes=int(c.saved_peak_bytes))
    rl = roofline_from(dict(flops=c.flops, flops_by_dtype=c.flops_by_dtype,
                            **{"bytes accessed": c.bytes}),
                       coll, mesh.size, cell.model_flops)
    return rl, coll, memd, c

"""Meshes of the port: the estimator's data mesh (the port's copy of the
JAX package's ``repro.launch.mesh.make_estimator_mesh``) and the
model-side meshes (``make_host_mesh``, ``make_production_mesh``).

The reference shards an estimate with ``shard_map`` over a one-axis
``("data",)`` mesh in one process.  The port keeps that model: one
process, one shard per entry of an ordered device list.  Shard ``d``
runs chunk offsets ``d, d + D, d + 2D, ...`` of every window on
``devices[d]`` and the engine sums the shards' exact int64 window sums
on the host (``core.engine``, ``dist.collectives.combine``).

Several shards may share one card: on a one-card machine a mesh of
``D`` shards puts all of them on ``cuda:0``, the counterpart of the
reference's ``--devices N`` (N virtual host devices on one CPU).  The
port takes the shard count as an argument and reads no environment, so
it has no counterpart of ``force_host_device_count``.

The model side is different: activations, gradients and optimizer state
cross ranks at every layer, so its mesh (``ModelMesh``) is one process
per rank on ``torch.distributed``.  Each process is handed its rank, the
world size and the rendezvous (``tcp://host:port`` or ``file://path``)
as arguments, and the backend (``"nccl"`` or ``"gloo"``) too.  Ranks
are laid out row-major with ``model`` innermost, as ``jax.make_mesh``
lays out devices, so the ranks of one tensor-parallel group are
neighbours.  Rank ``r`` runs on ``cuda:(r % device_count)``: on one card
every rank shares ``cuda:0``, which NCCL refuses, so such a mesh runs
over gloo (which copies CUDA tensors through the host).
``run_on_mesh`` starts the processes of a mesh from one parent
(spawned, not forked) and collects what each returns.

A *layout* mesh (``layout_mesh``, ``make_production_layout``) is a
``ModelMesh`` that no process joined: rank 0's view of any shape, the
reference's ``(16, 16)`` and ``(2, 16, 16)`` production meshes included,
on ``device="meta"``.  Its groups are ``dist.collectives.LayoutGroup``s,
which take meta tensors and move nothing, so a rank's step runs on it
for its shapes alone (``launch.dryrun``, ``roofline.cost``), and the
sharding builders, which read only ``axis_names`` and ``shape``, work on
it unchanged.
"""
from __future__ import annotations

import math
import os
import queue
import traceback
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..core.estimator import require_device
from ..dist.collectives import LayoutGroup
from ..dist.sharding import data_axes


@dataclass(frozen=True)
class EstimatorMesh:
    """A one-axis ``("data",)`` mesh: shard ``d`` runs on ``devices[d]``
    (the same device may appear more than once)."""

    devices: tuple

    axis_names = ("data",)

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_estimator_mesh(shards: int | None = None,
                        device: str = "cuda") -> EstimatorMesh:
    """A data mesh of ``shards`` shards on ``device``'s type.

    ``"cuda"``: one shard per visible card by default; ``shards=D``
    places shard ``d`` on ``cuda:(d % torch.cuda.device_count())``.
    Raises without a card (``require_device``), never falls back.
    ``"cpu"``: ``shards`` shards (default 1), all on the CPU.
    """
    device = require_device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        n = count if shards is None else int(shards)
        devices = tuple(torch.device("cuda", d % count) for d in range(n))
    else:
        n = 1 if shards is None else int(shards)
        devices = (device,) * n
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    return EstimatorMesh(devices)


class ModelMesh:
    """One rank's view of a ``(data, model)`` or ``(pod, data, model)``
    mesh of processes: the axes and their extents, this rank, its
    device, its coordinate along each axis, and one process group per
    axis (the ranks that differ only along it), plus one over the data
    axes together when there are two (``("pod", "data")``).  A group
    orders its ranks row-major by their coordinates, so this rank's
    place in ``group(axes)`` is ``coord(axes)``.  All the axes together
    are the world group (the flash-decoding layout's sequence over the
    data and model axes)."""

    def __init__(self, axis_names: tuple, dims: tuple, rank: int,
                 device: torch.device, backend: str, groups: dict):
        self.axis_names, self.dims = tuple(axis_names), tuple(dims)
        self.rank, self.device, self.backend = rank, device, backend
        self._groups = groups
        idx, coords = rank, {}
        for a, n in reversed(list(zip(self.axis_names, self.dims))):
            coords[a] = idx % n
            idx //= n
        self.coords = {a: coords[a] for a in self.axis_names}

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    @staticmethod
    def _axes(axes) -> tuple:
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def extent(self, axes) -> int:
        """The number of ranks along ``axes`` (a name or a tuple)."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def coord(self, axes) -> int:
        """This rank's row-major index along ``axes``."""
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes):
        """This rank's process group along ``axes``."""
        return self._groups[self._axes(axes)]

    def __repr__(self) -> str:
        return (f"ModelMesh({self.shape}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend!r})")


def _model_mesh(axis_names, dims, *, rank: int, world_size: int,
                init_method: str, backend: str, device,
                timeout_s: float = 600.0) -> ModelMesh:
    """Join (or reuse) the world of ``world_size`` ranks and build this
    rank's ``ModelMesh`` over it.  Every rank of the world calls it with
    the same axes, at the same point among its collectives: making the
    groups is itself collective."""
    if math.prod(dims) != world_size:
        raise ValueError(f"mesh {dict(zip(axis_names, dims))} has "
                         f"{math.prod(dims)} ranks, world size is "
                         f"{world_size}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    device = require_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError("nccl needs device='cuda'")
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, world_size):
            raise ValueError(
                f"process group already joined as rank {dist.get_rank()} "
                f"of {dist.get_world_size()}")
        if dist.get_backend() != backend:
            raise ValueError(f"process group runs {dist.get_backend()}, "
                             f"not {backend}")
    else:
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=world_size,
                                timeout=timedelta(seconds=timeout_s))
    names = tuple(axis_names)
    groups = {}
    mesh = ModelMesh(names, dims, rank, device, backend, groups)
    grid = torch.arange(world_size).reshape(dims)
    wanted = [(a,) for a in names]
    if len(data_axes(mesh)) > 1:
        wanted.append(data_axes(mesh))
    for axes in wanted:
        pos = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in pos]
        # one row per group: its ranks, row-major over ``axes``
        rows = grid.permute(rest + pos).reshape(
            -1, math.prod(dims[i] for i in pos))
        for row in rows.tolist():
            g = dist.new_group(row)           # collective: every rank
            if rank in row:
                groups[axes] = g
    # all the axes: the world itself, its ranks already row-major
    groups[names] = dist.group.WORLD
    return mesh


def make_host_mesh(data: int = 2, model: int = 2, pod: int = 0, *,
                   rank: int, world_size: int, init_method: str,
                   backend: str, device="cuda") -> ModelMesh:
    """A small ``(data, model)`` mesh, or ``(pod, data, model)`` when
    ``pod`` > 0 (the reference's defaults); ``world_size`` is the
    product.  ``device="cpu"`` puts every rank on the CPU (gloo)."""
    if pod:
        return _model_mesh(("pod", "data", "model"), (pod, data, model),
                           rank=rank, world_size=world_size,
                           init_method=init_method, backend=backend,
                           device=device)
    return _model_mesh(("data", "model"), (data, model), rank=rank,
                       world_size=world_size, init_method=init_method,
                       backend=backend, device=device)


def make_production_mesh(multi_pod: bool = False, *, rank: int,
                         world_size: int, init_method: str, backend: str,
                         device="cuda") -> ModelMesh:
    """The reference's production meshes: 256 ranks as ``(data=16,
    model=16)``, or 512 as ``(pod=2, data=16, model=16)``."""
    want = 512 if multi_pod else 256
    if world_size != want:
        raise ValueError(f"the {'multi-pod' if multi_pod else 'single-pod'}"
                         f" production mesh has {want} ranks, world size "
                         f"is {world_size}")
    return make_host_mesh(16, 16, 2 if multi_pod else 0, rank=rank,
                          world_size=world_size, init_method=init_method,
                          backend=backend, device=device)


class _LayoutGroups(dict):
    """A layout mesh's groups, one ``LayoutGroup`` per tuple of axes,
    made when first asked for."""

    def __init__(self, shape: dict):
        super().__init__()
        self.shape = shape

    def __missing__(self, axes):
        group = self[axes] = LayoutGroup(math.prod(self.shape[a]
                                                   for a in axes))
        return group


def layout_mesh(dims, axis_names=None) -> ModelMesh:
    """Rank 0's view of a mesh of ``dims`` that no process joins, on
    ``device="meta"``: ``axis_names`` default to ``("data", "model")``,
    or ``("pod", "data", "model")`` for three axes."""
    dims = tuple(int(d) for d in dims)
    if axis_names is None:
        axis_names = (("data", "model") if len(dims) == 2
                      else ("pod", "data", "model"))
    if len(axis_names) != len(dims):
        raise ValueError(f"axes {axis_names} for dims {dims}")
    return ModelMesh(axis_names, dims, 0, torch.device("meta"), "layout",
                     _LayoutGroups(dict(zip(axis_names, dims))))


def make_production_layout(multi_pod: bool = False) -> ModelMesh:
    """The reference's production meshes as layouts: ``(data=16,
    model=16)``, or ``(pod=2, data=16, model=16)``."""
    return layout_mesh((2, 16, 16) if multi_pod else (16, 16))


def _worker(fn, rank: int, world_size: int, init_method: str, args,
            results) -> None:
    try:
        out = fn(rank, world_size, init_method, *args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    results.put((rank, True, out))


def run_on_mesh(fn, world_size: int, rendezvous: str, args=(),
                timeout_s: float = 900.0) -> list:
    """Run ``fn(rank, world_size, init_method, *args)`` in
    ``world_size`` spawned processes and return their results in rank
    order.  ``rendezvous`` is a ``tcp://`` address or a file path for
    ``file://`` (it must not exist yet; it is removed afterwards).
    ``fn`` is pickled by reference (a module-level function) and the
    results by value.  A rank that raises, or no result within
    ``timeout_s``, fails the run: every rank is stopped and the error
    carries the failing rank's traceback."""
    path = None
    if rendezvous.startswith("tcp://"):
        init_method = rendezvous
    else:
        path = os.path.abspath(rendezvous)
        if os.path.exists(path):
            raise FileExistsError(f"rendezvous file {path} exists: a "
                                  "stale one would join an old world")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        init_method = f"file://{path}"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(fn, r, world_size,
                                               init_method, args, results),
                         daemon=True) for r in range(world_size)]
    for p in procs:
        p.start()
    got, failure = {}, None
    try:
        # drain the queue before joining: a writer blocks until it is read
        while len(got) < world_size:
            try:
                rank, ok, out = results.get(timeout=timeout_s)
            except queue.Empty:
                failure = f"no result within {timeout_s} s"
                break
            if not ok:
                failure = f"rank {rank} failed:\n{out}"
                break
            got[rank] = out
    finally:
        if failure is not None or len(got) < world_size:
            for p in procs:
                p.kill()
        for p in procs:
            p.join(timeout=60)
        if path is not None and os.path.exists(path):
            os.remove(path)
    if failure is not None:
        raise RuntimeError(f"run_on_mesh: {failure}")
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"run_on_mesh: ranks exited with {codes}")
    return [got[r] for r in range(world_size)]

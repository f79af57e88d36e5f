"""The estimator's data mesh (the port's copy of the JAX package's
``repro.launch.mesh.make_estimator_mesh``).

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
it has no counterpart of ``force_host_device_count``.  The model-side
meshes (``make_host_mesh``, ``make_production_mesh``) belong to the
model-side distribution slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.estimator import require_device


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

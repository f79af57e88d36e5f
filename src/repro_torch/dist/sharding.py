"""Mesh introspection (the port's copy of ``repro.dist.sharding``'s
``data_axes`` / ``n_data`` / ``n_model``).

A mesh here is any object with ``axis_names`` and a ``shape`` mapping
axis name to extent, as ``launch.mesh.EstimatorMesh`` is.
"""
from __future__ import annotations

import math


def data_axes(mesh) -> tuple:
    """Axis names carrying data parallelism (pod folds into data)."""
    names = [a for a in ("pod", "data") if a in mesh.axis_names]
    return tuple(names) if names else tuple(
        a for a in mesh.axis_names if a != "model")[:1]


def n_data(mesh) -> int:
    axes = data_axes(mesh)
    return math.prod(int(mesh.shape[a]) for a in axes) if axes else 1


def n_model(mesh) -> int:
    return int(mesh.shape["model"]) if "model" in mesh.axis_names else 1

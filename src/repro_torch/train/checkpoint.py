"""Step checkpoints with atomic manifests, in the reference's layout (the
port of ``repro.train.checkpoint``).

    ckpt_dir/step_000123/
      manifest.json       {step, leaves: [{path, file, shape, dtype}],
                           extra, done}
      leaf_00000.npy ...  one .npy per pytree leaf, full (unsharded)

Leaves are listed in jax's order with jax's ``keystr`` paths
(``train/pytree.py``), so a checkpoint written by either package
restores in the other.  Writes go to ``<dir>.tmp``, then ``os.replace``;
``latest_step`` trusts only manifests marked ``done``.  ``restore``
places each leaf on ``device`` (the reference's ``shardings``), or on
the device of the matching leaf of ``like``.  numpy has no bfloat16:
a bf16 leaf is refused (the training state is f32).

A sharded run (``mesh=`` and a ``PartitionSpec`` per leaf, ``specs=``;
``dist.sharding``) writes the same format: each leaf is gathered in
full (a collective, leaf by leaf) and rank 0 writes it, then every rank
waits for the manifest.  ``restore`` reads the full leaves on every rank
and keeps the rank's piece, so a checkpoint crosses mesh shapes and a
meshless run reads it.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from . import pytree

Pytree = Any


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise ValueError("checkpoint: numpy has no bfloat16; keep the "
                             "state in f32")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: Pytree,
         extra: dict | None = None, mesh=None, specs=None) -> str:
    """Write a checkpoint; returns the final directory path.  With
    ``mesh`` every rank calls it with its pieces (``specs``: one
    ``PartitionSpec`` per leaf) and rank 0 writes the full leaves."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    writer = mesh is None or mesh.rank == 0
    if writer:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
    flat = pytree.flatten_with_paths(tree)
    spec_of = ([None] * len(flat) if mesh is None
               else pytree.leaves(specs))
    entries = []
    for i, ((path, leaf), spec) in enumerate(zip(flat, spec_of,
                                                 strict=True)):
        if mesh is not None:
            from ..dist.sharding import unshard
            leaf = unshard(leaf, spec, mesh)
        if not writer:
            continue
        arr = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        entries.append(dict(path=path, file=fname, shape=list(arr.shape),
                            dtype=str(arr.dtype)))
    if writer:
        manifest = dict(step=step, leaves=entries, extra=extra or {},
                        done=True)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    if mesh is not None:
        import torch.distributed as dist
        dist.barrier()
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """Largest step with a complete (done) manifest, else None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        mpath = os.path.join(ckpt_dir, name, "manifest.json")
        try:
            with open(mpath) as f:
                man = json.load(f)
            if man.get("done"):
                s = int(man["step"])
                best = s if best is None else max(best, s)
        except (OSError, ValueError, KeyError):
            continue
    return best


def restore(ckpt_dir: str, step: int, like: Pytree, device=None,
            mesh=None, specs=None) -> tuple[Pytree, dict]:
    """Restore into the structure of ``like`` (paths and shapes checked,
    each leaf cast to the dtype of its ``like`` leaf).  Returns ``(tree,
    extra)``; leaves are tensors on ``device``, else on their ``like``
    leaf's device (the CPU for non-tensor leaves).  With ``mesh`` the
    leaves of ``like`` are this rank's pieces under ``specs``: each full
    leaf read is checked against the pieces' full shape and cut to the
    rank's piece."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    want, tdef = pytree.flatten_with_paths(like), pytree.flatten(like)[1]
    if len(want) != len(man["leaves"]):
        raise ValueError(f"leaf count mismatch: ckpt {len(man['leaves'])} "
                         f"vs target {len(want)}")
    spec_of = ([None] * len(want) if mesh is None
               else pytree.leaves(specs))
    leaves = []
    for (path, leaf), ent, spec in zip(want, man["leaves"], spec_of,
                                       strict=True):
        if ent["path"] != path:
            raise ValueError(f"leaf path mismatch: {ent['path']} vs {path}")
        arr = np.load(os.path.join(d, ent["file"]))
        if isinstance(leaf, torch.Tensor):
            shape, dtype = tuple(leaf.shape), leaf.dtype
            dev = device if device is not None else leaf.device
        else:
            ref = np.asarray(leaf)
            shape, dtype = ref.shape, torch.from_numpy(ref.copy()).dtype
            dev = device if device is not None else "cpu"
        full = torch.from_numpy(arr)
        if mesh is not None:
            from ..dist.sharding import shard
            shape = tuple(n * mesh.extent(a) if a is not None else n
                          for n, a in zip(shape, spec.padded(len(shape))))
        if tuple(arr.shape) != shape:
            raise ValueError(f"{path}: shape {arr.shape} != {shape}")
        if mesh is not None:
            full = shard(full, spec, mesh)
        leaves.append(full.to(device=dev, dtype=dtype))
    return pytree.unflatten(tdef, leaves), man.get("extra", {})


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` complete checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append(int(name[5:]))
            except ValueError:
                pass
    for s in sorted(steps)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)

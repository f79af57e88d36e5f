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
         extra: dict | None = None) -> str:
    """Write a checkpoint; returns the final directory path."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    entries = []
    for i, (path, leaf) in enumerate(pytree.flatten_with_paths(tree)):
        arr = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        entries.append(dict(path=path, file=fname, shape=list(arr.shape),
                            dtype=str(arr.dtype)))
    manifest = dict(step=step, leaves=entries, extra=extra or {}, done=True)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
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


def restore(ckpt_dir: str, step: int, like: Pytree,
            device=None) -> tuple[Pytree, dict]:
    """Restore into the structure of ``like`` (paths and shapes checked,
    each leaf cast to the dtype of its ``like`` leaf).  Returns ``(tree,
    extra)``; leaves are tensors on ``device``, else on their ``like``
    leaf's device (the CPU for non-tensor leaves)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    want, tdef = pytree.flatten_with_paths(like), pytree.flatten(like)[1]
    if len(want) != len(man["leaves"]):
        raise ValueError(f"leaf count mismatch: ckpt {len(man['leaves'])} "
                         f"vs target {len(want)}")
    leaves = []
    for (path, leaf), ent in zip(want, man["leaves"]):
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
        if tuple(arr.shape) != shape:
            raise ValueError(f"{path}: shape {arr.shape} != {shape}")
        leaves.append(torch.from_numpy(arr).to(device=dev, dtype=dtype))
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

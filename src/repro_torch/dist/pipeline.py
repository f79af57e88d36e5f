"""GPipe-style pipeline parallelism over the ``"pod"`` axis (the port of
``repro.dist.pipeline``).

``gpipe_forward`` runs stage ``s`` of an ``n_stage``-deep network on the
rank at pod coordinate ``s`` and streams microbatches through: at step
``t`` stage ``s`` processes microbatch ``t - s`` and ships its
activation to stage ``s + 1`` (``collectives.ppermute``), the classic
fill / steady / drain schedule of ``n_mb + n_stage - 1`` steps.  The
last stage's outputs are then summed over the axis with every other
stage's zeros (the reference's closing ``psum`` of ``outs * keep``), so
every rank returns them.  The same maths as running every microbatch
through the stages serially (the test oracle).  Forward only, as the
reference.
"""
from __future__ import annotations

import torch

from . import collectives as coll


def gpipe_forward(stage_fn, stage_params: torch.Tensor, xs: torch.Tensor,
                  mesh, axis: str = "pod") -> torch.Tensor:
    """``stage_params [n_stage, ...]`` (this rank runs row ``mesh.coord(
    axis)``), ``xs [n_mb, B, ...]`` on every rank of ``axis``; returns
    ``[n_mb, B, ...]``, every microbatch after all stages, on every
    rank.  ``stage_fn(w, h)`` keeps ``h``'s shape."""
    n_stage = int(mesh.shape[axis])
    if stage_params.shape[0] != n_stage:
        raise ValueError(f"{stage_params.shape[0]} stages on a "
                         f"{n_stage}-deep {axis!r} axis")
    n_mb = xs.shape[0]
    group, stage = mesh.group(axis), mesh.coord(axis)
    last = stage == n_stage - 1
    w = stage_params[stage]
    state = torch.zeros_like(xs[0])
    outs = [torch.zeros_like(xs[0])] * n_mb
    for t in range(n_mb + n_stage - 1):
        # stage 0 ingests microbatch t (a repeat after the fill: it never
        # reaches an emit slot)
        out = stage_fn(w, xs[min(t, n_mb - 1)] if stage == 0 else state)
        emit = t - (n_stage - 1)
        if last and 0 <= emit < n_mb:
            outs[emit] = out
        state = coll.ppermute(out, group, 1)
    return coll.psum(torch.stack(outs), group)

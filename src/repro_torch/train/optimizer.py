"""AdamW with a cosine schedule and global-norm clipping, over parameter
trees (the port of ``repro.train.optimizer``).

Parameters are nested dicts / lists of tensors (``train/pytree.py``);
the optimizer state is f32 whatever the parameters' dtype, one moment
pair per float leaf (a non-float leaf gets ``zeros(())`` moments and is
left as it is).  Updates run under ``torch.no_grad()`` on the devices of
the parameters.

``adamw_update`` returns new tensors and leaves its inputs as they were,
as the reference's jitted step does: a step that raises part-way leaves
the state it was given intact, so ``run_resumable`` can retry or skip
it.  Beyond the new state it holds one leaf-sized temporary at a time.

On a model mesh (``mesh=``, one rank of a ``launch.mesh.ModelMesh``)
each leaf is this rank's piece under its ``PartitionSpec``
(``dist.sharding``) and the gradients are already summed over the data
axes.  ``global_norm`` sums each leaf's local squares, reduces them over
the axes that shard the leaf and counts a replicated leaf once.  With
ZeRO (moment specs from ``opt_state_shardings(zero=True)``, which shard
a moment's dimension over the data axes where its parameter is
replicated) a rank keeps only its slice of ``mu`` and ``nu`` and is
handed only the matching slice of the summed gradient (``train.steps``
reduce-scatters it): it updates that slice of the parameter and
all-gathers the updated slices over the data axes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from . import pytree

Pytree = Any


class AdamState(NamedTuple):
    step: torch.Tensor     # scalar int32
    mu: Pytree             # first moment (f32)
    nu: Pytree             # second moment (f32)


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_frac * lr`` (f32)."""
    s = torch.as_tensor(step).float()
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def _sharding_axes(spec) -> tuple:
    """The entries of a ``PartitionSpec`` that shard (names or tuples)."""
    return tuple(a for a in spec if a is not None)


@torch.no_grad()
def global_norm(tree: Pytree, mesh=None, specs=None) -> torch.Tensor:
    """The L2 norm over every leaf.  With ``mesh`` each leaf is a piece
    under its spec in ``specs``: the squares of the leaves sharded over
    the same axes are summed, then over those axes' ranks."""
    if mesh is None:
        sq = [torch.sum(torch.square(x.float()))
              for x in pytree.leaves(tree)]
        return torch.sqrt(torch.sum(torch.stack(sq)))
    from ..dist.collectives import all_reduce
    buckets: dict = {}
    for x, spec in zip(pytree.leaves(tree), pytree.leaves(specs),
                       strict=True):
        buckets.setdefault(_sharding_axes(spec), []).append(
            torch.sum(torch.square(x.float())))
    total = []
    for axes, sq in buckets.items():
        s = torch.sum(torch.stack(sq))
        for a in axes:
            s = all_reduce(s, mesh.group(a))
        total.append(s)
    return torch.sqrt(torch.sum(torch.stack(total)))


@torch.no_grad()
def clip_by_global_norm(grads: Pytree, max_norm: float, mesh=None,
                        specs=None):
    """``(grads * min(1, max_norm / norm), norm)``, new f32 gradients."""
    gn = global_norm(grads, mesh, specs)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return pytree.tree_map(lambda g: g.float() * scale, grads), gn


def zero_dim(p_spec, m_spec, ndim: int):
    """``(dim, axes)`` where a moment's spec shards a dimension its
    parameter's does not (ZeRO), else None."""
    for i, (a, b) in enumerate(zip(p_spec.padded(ndim),
                                   m_spec.padded(ndim))):
        if a != b:
            return i, b
    return None


def _moment(p, zero=None, mesh=None):
    if not torch.is_floating_point(p):
        return torch.zeros((), dtype=torch.float32, device=p.device)
    shape = list(p.shape)
    if zero is not None:
        dim, axes = zero
        shape[dim] //= mesh.extent(axes)
    return torch.zeros(shape, dtype=torch.float32, device=p.device)


def zero_dims(params, mesh, param_specs, state_specs) -> list:
    """Per leaf of ``params``, ``zero_dim`` of its specs (all None
    without a mesh or moment specs)."""
    flat = pytree.leaves(params)
    if mesh is None or state_specs is None:
        return [None] * len(flat)
    return [zero_dim(ps, ms, p.dim()) for p, ps, ms in zip(
        flat, pytree.leaves(param_specs), pytree.leaves(state_specs.mu),
        strict=True)]


def adamw_init(params: Pytree, mesh=None, param_specs=None,
               state_specs=None) -> AdamState:
    """Zero moments and step.  On a mesh with ZeRO moment specs
    (``state_specs``) each moment is this rank's slice."""
    flat, tdef = pytree.flatten(params)
    device = flat[0].device if flat else "cpu"
    zeros = zero_dims(params, mesh, param_specs, state_specs)

    def moments():
        return pytree.unflatten(tdef, [_moment(p, z, mesh)
                                       for p, z in zip(flat, zeros)])
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     mu=moments(), nu=moments())


def _adamw_leaf(cfg, lr, b1c, b2c, p, g, m, v):
    """One leaf's new ``(p, m, v)``; ``p``, ``m`` and ``v`` are only
    read.  ``g`` is the clipped f32 gradient, made for this update:
    once the moments have read it, it holds the step."""
    if not torch.is_floating_point(p):
        return p, m, v
    m2 = (m * cfg.b1).add_(g, alpha=1 - cfg.b1)
    v2 = (v * cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
    den = torch.div(v2, b2c).sqrt_().add_(cfg.eps)
    upd = torch.div(m2, b1c, out=g).div_(den)
    del den
    pf = p.float()
    upd.add_(pf, alpha=cfg.weight_decay)
    return torch.sub(pf, upd.mul_(lr)).to(p.dtype), m2, v2


def _adamw_zero_leaf(cfg, lr, b1c, b2c, p, g, m, v, zero, mesh):
    """``_adamw_leaf`` on this rank's slice along the ZeRO dimension
    (``g`` is that slice already), the updated slices all-gathered over
    the data axes."""
    if not torch.is_floating_point(p):
        return p, m, v
    from ..dist.collectives import all_gather_dim
    dim, axes = zero
    size = p.shape[dim] // mesh.extent(axes)
    p_s, m2, v2 = _adamw_leaf(cfg, lr, b1c, b2c,
                              p.narrow(dim, mesh.coord(axes) * size, size),
                              g, m, v)
    return all_gather_dim(p_s, dim, mesh.group(axes)), m2, v2


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Pytree, state: AdamState,
                 params: Pytree, mesh=None, param_specs=None,
                 state_specs=None):
    """Returns ``(new_params, new_state, metrics)`` with metrics
    ``grad_norm`` (before clipping) and ``lr``.  On a mesh the leaves
    are this rank's pieces under ``param_specs``, the moments and the
    gradients (summed over the data axes) under ``state_specs`` (ZeRO:
    see the module docstring)."""
    grad_specs = (param_specs if state_specs is None or mesh is None
                  else state_specs.mu)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, mesh,
                                       grad_specs)
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    flat_p, tdef = pytree.flatten(params)
    flat_g, flat_m, flat_v = (pytree.leaves(t)
                              for t in (grads, state.mu, state.nu))
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("adamw_update: trees of different structure")
    zeros = zero_dims(params, mesh, param_specs, state_specs)
    out = [_adamw_leaf(cfg, lr, b1c, b2c, p, g, m, v) if z is None
           else _adamw_zero_leaf(cfg, lr, b1c, b2c, p, g, m, v, z, mesh)
           for p, g, m, v, z in zip(flat_p, flat_g, flat_m, flat_v, zeros)]
    new_p = pytree.unflatten(tdef, [o[0] for o in out])
    new_m = pytree.unflatten(tdef, [o[1] for o in out])
    new_v = pytree.unflatten(tdef, [o[2] for o in out])
    metrics = dict(grad_norm=gnorm, lr=lr)
    return new_p, AdamState(step=step, mu=new_m, nu=new_v), metrics


@torch.no_grad()
def sgd_update(lr: float, grads: Pytree, params: Pytree) -> Pytree:
    """Plain SGD (tests / tiny examples)."""
    return pytree.tree_map(
        lambda p, g: (p.float() - lr * g.float()).to(p.dtype), params,
        grads)

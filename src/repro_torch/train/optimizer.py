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


@torch.no_grad()
def global_norm(tree: Pytree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in pytree.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def clip_by_global_norm(grads: Pytree, max_norm: float):
    """``(grads * min(1, max_norm / norm), norm)``, new f32 gradients."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return pytree.tree_map(lambda g: g.float() * scale, grads), gn


def _moment(p):
    if torch.is_floating_point(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return torch.zeros((), dtype=torch.float32, device=p.device)


def adamw_init(params: Pytree) -> AdamState:
    leaves = pytree.leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     mu=pytree.tree_map(_moment, params),
                     nu=pytree.tree_map(_moment, params))


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


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Pytree, state: AdamState,
                 params: Pytree):
    """Returns ``(new_params, new_state, metrics)`` with metrics
    ``grad_norm`` (before clipping) and ``lr``."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    flat_p, tdef = pytree.flatten(params)
    flat_g, flat_m, flat_v = (pytree.leaves(t)
                              for t in (grads, state.mu, state.nu))
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("adamw_update: trees of different structure")
    out = [_adamw_leaf(cfg, lr, b1c, b2c, p, g, m, v)
           for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v)]
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

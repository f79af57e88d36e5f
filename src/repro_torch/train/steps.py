"""Train-step factories: gradient accumulation and int8 gradient
compression (the port of ``repro.train.steps``).

``make_train_step(loss_fn, opt_cfg, ...)`` builds ``step(params,
opt_state, batch, rng=None) -> (params, opt_state, metrics)``:

* gradients come from ``torch.autograd`` (``value_and_grad``);
* ``accum_steps > 1`` splits every batch leaf on axis 0 into that many
  microbatches and sums their losses and gradients in f32 (the
  reference's ``lax.scan``), then divides by the count.  Each
  microbatch's loss and gradient come from ``step.grads_of(params,
  batch)`` (``value_and_grad(loss_fn, mark)``); a caller may wrap it,
  as ``roofline.analysis`` does to count repeated microbatches once;
* ``compress_grads`` int8-quantizes each gradient leaf with stochastic
  rounding (``compress_decompress``), leaf ``i`` drawing jax's uniform
  bits from ``split(rng, n_leaves)[i]`` (``rng`` defaults to
  ``PRNGKey(0)``), bit-equal to the reference under the same key; on a
  mesh each rank quantizes its piece of the summed gradient with the
  full leaf's scale and the full leaf's draws at its elements, so the
  pieces are the full leaf's result bit for bit;
* ``mark(name)``, if given, is called as each part of the step begins:
  ``"forward"`` and ``"backward"`` (once per microbatch),
  ``"optimizer"``, then ``"end"``; a caller times the parts with it.

``loss_fn(params, batch) -> scalar`` is any differentiable torch
function of a parameter tree (``train/pytree.py``).

On a model mesh (``mesh=``, one rank of a ``launch.mesh.ModelMesh``;
``loss_fn`` a mesh-aware loss such as ``transformer.train_loss(...,
mesh=mesh)``) every rank is handed the same global batch.  Microbatch
``i`` is rows ``[i B/A, (i+1) B/A)`` (the reference's reshape) and data
rank ``r`` takes its contiguous share of them (``share``, if given,
cuts a rank's piece of a microbatch instead: the edge-parallel GNN's
``dist.gnn_sharded.local_batch``); ``loss_fn`` returns the
global loss and this rank's part of the gradient.  The gradients of the
leaves that the data axes do not shard (``param_specs``) are summed over
them once a step, after accumulation: reduce-scattered where ZeRO
shards the leaf's moments (``state_specs``), so a rank holds the slice
of the summed gradient its moments update, all-reduced elsewhere.  The
optimizer then runs on the rank's pieces (``adamw_update``).
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from ..core import rng as _rng
from ..dist.sharding import data_axes, n_data
from . import pytree
from .optimizer import AdamWConfig, adamw_update


_CHUNK = 1 << 24        # elements quantized at a time


def _global_index(shape, spec, mesh, start: int, stop: int, device):
    """Flat indices in the full leaf of a piece's flat elements
    ``[start, stop)`` (the piece of ``shape`` under ``spec``)."""
    j = torch.arange(start, stop, dtype=torch.int64, device=device)
    idx = torch.zeros_like(j)
    loc_stride = full_stride = 1
    for size, axes in reversed(list(zip(shape, spec.padded(len(shape))))):
        n, off = 1, 0
        if axes is not None:
            n, off = mesh.extent(axes), mesh.coord(axes) * size
        idx += (off + (j // loc_stride) % size) * full_stride
        loc_stride *= size
        full_stride *= size * n
    return idx


def compress_decompress(g: torch.Tensor, key: torch.Tensor, mesh=None,
                        spec=None) -> torch.Tensor:
    """int8-quantize with stochastic rounding, then dequantize (f32).

    One f32 scale per leaf (``max |g| / 127``); ``x = g / scale`` rounds
    up where ``uniform(key) < frac(x)``, which keeps the quantizer
    unbiased.  The draws are jax's float32 ``uniform`` bits.

    With ``mesh`` and ``spec`` (a ``PartitionSpec``) ``g`` is this rank's
    piece of the leaf: the max is all-reduced over the axes that shard
    it and the draws are the full leaf's at the piece's elements
    (``rng.uniform_at``), so the piece equals that piece of the full
    leaf's result bit for bit.  The leaf goes through in slices of
    ``_CHUNK`` elements: a leaf of 10^9 elements is never drawn whole.
    """
    flat = g.float().reshape(-1)
    amax = flat.new_zeros(())
    for part in flat.split(_CHUNK):
        amax = torch.maximum(amax, part.abs().max())
    if mesh is not None and spec is not None:
        from ..dist.collectives import all_reduce
        for axes in spec:
            if axes is not None:
                amax = all_reduce(amax, mesh.group(axes),
                                  torch.distributed.ReduceOp.MAX)
    else:
        spec = None
    scale = torch.clamp(amax, min=1e-30) / 127.0
    key = key.to(g.device)
    out = torch.empty_like(flat)
    for start in range(0, flat.numel(), _CHUNK):
        stop = min(start + _CHUNK, flat.numel())
        if spec is None:
            idx = torch.arange(start, stop, device=g.device)
        else:
            idx = _global_index(g.shape, spec, mesh, start, stop, g.device)
        x = flat[start:stop] / scale
        lo = torch.floor(x)
        r = _rng.uniform_at(key, idx)
        q = torch.clamp(lo + (r < x - lo), -127, 127).to(torch.int8)
        out[start:stop] = q.float() * scale
    return out.reshape(g.shape)


def _compress_tree(grads, key, mesh=None, specs=None):
    leaves, tdef = pytree.flatten(grads)
    keys = _rng.split(key, len(leaves))
    specs = (pytree.leaves(specs) if mesh is not None and specs is not None
             else [None] * len(leaves))
    return pytree.unflatten(tdef, [
        compress_decompress(g, k, mesh, s if g.dim() else None)
        for g, k, s in zip(leaves, keys, specs, strict=True)])


def _no_mark(name: str) -> None:
    pass


def value_and_grad(loss_fn: Callable,
                   mark: Callable[[str], None] | None = None) -> Callable:
    """``(params, batch) -> (loss, grads)``: the loss (detached) and its
    gradient with respect to every float leaf of ``params`` (zeros where
    the loss does not reach a leaf; ``zeros(())`` for non-float leaves),
    as a tree of the params' structure.  ``mark`` as in
    ``make_train_step``."""
    mark = mark or _no_mark

    def run(params, batch):
        flat, tdef = pytree.flatten(params)
        live = [p.detach().requires_grad_(torch.is_floating_point(p))
                for p in flat]
        with torch.enable_grad():
            mark("forward")
            loss = loss_fn(pytree.unflatten(tdef, live), batch)
            mark("backward")
            wrt = [p for p in live if p.requires_grad]
            got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
        grads = []
        for p in live:
            if not p.requires_grad:
                grads.append(torch.zeros((), device=p.device))
                continue
            g = next(got)
            grads.append(torch.zeros_like(p) if g is None else g)
        return loss.detach(), pytree.unflatten(tdef, grads)
    return run


def data_share(x: torch.Tensor, mesh) -> torch.Tensor:
    """Data rank ``r``'s contiguous share of a microbatch's rows."""
    n, r = n_data(mesh), mesh.coord(data_axes(mesh))
    if x.shape[0] % n:
        raise ValueError(f"a microbatch of {x.shape[0]} rows does not "
                         f"divide over {n} data ranks")
    size = x.shape[0] // n
    return x[r * size:(r + 1) * size]


def sum_over_data(grads, mesh, param_specs, state_specs=None):
    """Each leaf the data axes do not shard, summed over them: reduce-
    scattered along its ZeRO dimension where ``state_specs`` gives one
    (the rank keeps the slice its moments update), else all-reduced."""
    from ..dist.collectives import all_reduce, reduce_scatter_dim
    from .optimizer import zero_dims
    da = data_axes(mesh)
    group = mesh.group(da)
    flat, tdef = pytree.flatten(grads)
    specs = (pytree.leaves(param_specs) if param_specs is not None
             else [()] * len(flat))
    zeros = zero_dims(grads, mesh, param_specs, state_specs)
    out = []
    for g, spec, zero in zip(flat, specs, zeros, strict=True):
        if any(a in (da, *da) for a in spec if a is not None):
            out.append(g)
        elif zero is not None and torch.is_floating_point(g):
            out.append(reduce_scatter_dim(g, zero[0], group))
        else:
            out.append(all_reduce(g, group))
    return pytree.unflatten(tdef, out)


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig,
                    accum_steps: int = 1, compress_grads: bool = False,
                    mark: Callable[[str], None] | None = None, mesh=None,
                    param_specs=None, state_specs=None,
                    share: Callable | None = None):
    """``loss_fn(params, batch) -> scalar``; returns the step function.

    With ``accum_steps > 1`` every tensor in ``batch`` must have a leading
    axis divisible by ``accum_steps``.  ``mesh`` / ``param_specs`` /
    ``state_specs`` / ``share``: the module docstring.
    """
    mark = mark or _no_mark
    grads_of = value_and_grad(loss_fn, mark)
    # the layout of the summed gradient: a leaf's moment spec (ZeRO's
    # slice where it has one), else its param spec
    grad_specs = state_specs.mu if state_specs is not None else param_specs
    if mesh is None:
        share = None
    elif share is None:
        share = partial(pytree.tree_map, lambda x: data_share(x, mesh))

    def cut(b):
        return b if share is None else share(b)

    def step(params, opt_state, batch, rng=None):
        if accum_steps == 1:
            loss, grads = step.grads_of(params, cut(batch))
        else:
            split = pytree.tree_map(
                lambda x: x.reshape((accum_steps, x.shape[0] // accum_steps)
                                    + tuple(x.shape[1:])), batch)
            loss, grads = None, None
            for a in range(accum_steps):
                mb = cut(pytree.tree_map(lambda x: x[a], split))
                l, g = step.grads_of(params, mb)
                g = pytree.tree_map(lambda x: x.float(), g)
                if grads is None:
                    loss, grads = l.float(), g
                else:
                    loss = loss + l.float()
                    grads = pytree.tree_map(torch.Tensor.add_, grads, g)
        if mesh is not None:
            grads = sum_over_data(grads, mesh, param_specs, state_specs)
        if accum_steps > 1:
            loss = loss / accum_steps
            grads = pytree.tree_map(lambda g: g / accum_steps, grads)
        if compress_grads:
            key = rng if rng is not None else _rng.PRNGKey(0)
            grads = _compress_tree(grads, key, mesh, grad_specs)
        mark("optimizer")
        params, opt_state, om = adamw_update(
            opt_cfg, grads, opt_state, params, mesh=mesh,
            param_specs=param_specs, state_specs=state_specs)
        mark("end")
        return params, opt_state, dict(loss=loss, **om)

    step.grads_of = grads_of
    return step


def make_eval_step(loss_fn: Callable):
    def step(params, batch):
        with torch.no_grad():
            return loss_fn(params, batch)
    return step

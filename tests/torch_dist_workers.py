"""Rank programs of the port's model-mesh tests (``tests/test_torch_dist_
*.py``): module-level functions that ``launch.mesh.run_on_mesh`` runs in
spawned CPU processes over gloo.

They import no jax: the tests compute the reference in the parent
process and hand the ranks numpy inputs; the ranks hand back numpy
results (rank 0's, gathered in full, unless said otherwise).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch


def mesh_of(dims, rank, world_size, init_method, device="cpu",
            backend="gloo"):
    """This rank's mesh of ``dims`` ((data, model) or (pod, data,
    model)); a CPU rank computes on one thread (four ranks share the
    test worker's cores)."""
    from repro_torch.launch.mesh import make_host_mesh
    if device == "cpu":
        torch.set_num_threads(1)
    data, model = dims[-2:]
    pod = dims[0] if len(dims) == 3 else 0
    return make_host_mesh(data, model, pod, rank=rank, world_size=world_size,
                          init_method=init_method, backend=backend,
                          device=device)


def lm_config(case):
    """The case's smoke config: ``capacity_factor`` / ``remat`` as given,
    ``residual_spec`` set when ``sp``."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(case["arch"])
    cfg = dataclasses.replace(cfg, **case.get("replace", {}))
    if case.get("sp"):
        cfg = dataclasses.replace(cfg, residual_spec=(("data",), "model",
                                                      None))
    return cfg


def _grads_full(cfg, mesh, params_np, batch_np, dtype, pinned):
    """The global loss and every gathered gradient leaf (f32 numpy, jax's
    leaf order) on ``mesh``; the routes this rank took (None where they
    were pinned to ``pinned``, the reference's)."""
    from repro_torch.dist.sharding import data_axes, n_data, unshard
    from repro_torch.models import transformer
    from repro_torch.models.convert import shard_lm_tree
    from repro_torch.train import pytree
    from repro_torch.train.steps import data_share, sum_over_data
    from repro_torch.train.steps import value_and_grad
    from repro_torch.testing import MeshRoutes
    tp = transformer.layout(cfg, mesh)
    params = shard_lm_tree(cfg, params_np, mesh, tp.specs)
    batch = {k: data_share(torch.as_tensor(v), mesh).to(mesh.device)
             for k, v in batch_np.items()}
    loss_fn = partial(transformer.train_loss, cfg, compute_dtype=dtype,
                      mesh=mesh)
    if pinned is not None:
        ctx = MeshRoutes(pinned).pin(mesh.coord(data_axes(mesh)))
    else:
        ctx = MeshRoutes().record()
    with ctx as routes:
        loss, grads = value_and_grad(loss_fn)(params, batch)
    grads = sum_over_data(grads, mesh, tp.specs)
    full = [unshard(g.float(), s, mesh).cpu().numpy() for g, s in
            zip(pytree.leaves(grads), pytree.leaves(tp.specs), strict=True)]
    return (float(loss), full, routes.calls if pinned is None else None,
            n_data(mesh))


def lm_grads(rank, world_size, init_method, cases):
    """For each case ``{arch, dims, sp, dtype, params, batch, pinned,
    replace}`` (and ``device`` / ``backend``, default the CPU over
    gloo): rank 0 returns ``(loss, [gradient leaves])``; every rank
    returns the routes it took, with its mesh coordinates."""
    out = []
    for case in cases:
        mesh = mesh_of(case["dims"], rank, world_size, init_method,
                       case.get("device", "cpu"),
                       case.get("backend", "gloo"))
        cfg = lm_config(case)
        dtype = getattr(torch, case["dtype"])
        loss, grads, routes, _ = _grads_full(cfg, mesh, case["params"],
                                             case["batch"], dtype,
                                             case.get("pinned"))
        out.append(dict(loss=loss, grads=grads if rank == 0 else None,
                        routes=routes, coords=dict(mesh.coords)))
    return out


def lm_steps(rank, world_size, init_method, case):
    """``case["steps"]`` f32 ``make_train_step`` steps on the case's mesh
    (accumulation ``case["accum"]``, ZeRO when ``case["zero"]``): each
    step's loss and grad norm, then (rank 0) every leaf of the final
    params and AdamW state, gathered, in jax's leaf order."""
    from repro_torch.dist.sharding import opt_state_shardings, unshard
    from repro_torch.models import transformer
    from repro_torch.models.convert import shard_lm_tree
    from repro_torch.train import pytree
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_train_step
    mesh = mesh_of(case["dims"], rank, world_size, init_method)
    cfg = lm_config(case)
    tp = transformer.layout(cfg, mesh)
    o_specs = opt_state_shardings(tp.specs, mesh,
                                  transformer.abstract_params(cfg),
                                  zero=case["zero"])
    params = shard_lm_tree(cfg, case["params"], mesh, tp.specs)
    opt = adamw_init(params, mesh, tp.specs, o_specs)
    step = make_train_step(
        partial(transformer.train_loss, cfg, compute_dtype=torch.float32,
                mesh=mesh), AdamWConfig(**case["opt"]),
        accum_steps=case["accum"], mesh=mesh, param_specs=tp.specs,
        state_specs=o_specs)
    metrics = []
    for b in case["batches"]:
        params, opt, m = step(params, opt, {k: torch.as_tensor(v)
                                            for k, v in b.items()})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    state = dict(params=params, opt=opt)
    specs = dict(params=tp.specs, opt=o_specs)
    leaves = [unshard(x, s, mesh).numpy() for x, s in zip(
        pytree.leaves(state), pytree.leaves(specs), strict=True)]
    local_moment = pytree.leaves(opt.mu)[0].shape
    return dict(metrics=metrics, leaves=leaves if rank == 0 else None,
                local_moment=tuple(local_moment))


def collectives_checks(rank, world_size, init_method):
    """On ``(data=2, model=2)`` and ``(pod=2, data=1, model=2)`` over the
    same 4 ranks: the layout and groups, ``psum_chunked`` against one
    all-reduce, ``sharded_embedding_lookup`` and its gradient against a
    plain take, each autograd pair against its plain collectives, and
    ``shard_tree`` then ``unshard_tree`` of an LM training state.
    Asserts on every rank; returns what each rank saw."""
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.dist import collectives as C
    from repro_torch.dist import sharding as shd
    from repro_torch.models import transformer
    from repro_torch.models.convert import (gather_lm_tree, numpy_params,
                                            shard_lm_tree, tree_from_numpy)
    from repro_torch.train import pytree
    from repro_torch.train.optimizer import adamw_init
    seen = {}
    mesh = mesh_of((2, 2), rank, world_size, init_method)
    d, m = divmod(rank, 2)
    assert mesh.coords == dict(data=d, model=m)
    for axes, want in ((("model",), [2 * d, 2 * d + 1]),
                       (("data",), [m, 2 + m])):
        g = C.all_gather_dim(torch.tensor([rank]), 0, mesh.group(axes))
        assert g.tolist() == want, (axes, g)
        assert dist.get_rank(mesh.group(axes)) == mesh.coord(axes)

    # psum_chunked == one all-reduce, payloads that do not divide
    r = np.random.default_rng(rank)
    for dtype in (torch.float32, torch.int64):
        x = torch.as_tensor(r.integers(-50, 50, (7, 5))).to(dtype) / (
            3 if dtype == torch.float32 else 1)
        for axis in ("model", "data"):
            one = C.all_reduce(x, mesh.group(axis))
            for n_chunks in (1, 3, 36):
                got = C.psum_chunked(x, axis, n_chunks, mesh=mesh)
                assert got.dtype == x.dtype and torch.equal(got, one)
    seen["psum"] = True

    # sharded_embedding_lookup: -1 ids give zero rows, the gradient only
    # the local rows
    full = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (12, 3)), dtype=torch.float32)
    ids = torch.as_tensor(np.random.default_rng(10).integers(-1, 12, (4, 5)))
    local = shd.shard(full, shd.P("model", None), mesh).requires_grad_()
    up = torch.as_tensor(np.random.default_rng(11).standard_normal((4, 5, 3)),
                         dtype=torch.float32)
    out = C.sharded_embedding_lookup(local, ids, mesh)
    want = torch.where(ids[..., None] >= 0, full[ids.clamp(min=0)], 0.0)
    assert torch.equal(out, want)
    (grad,) = torch.autograd.grad(out, local, up)
    ref = full.clone().requires_grad_()
    (gfull,) = torch.autograd.grad(
        torch.where(ids[..., None] >= 0, ref[ids.clamp(min=0)], 0.0), ref,
        up)
    assert torch.allclose(grad, gfull[6 * m:6 * m + 6], atol=1e-6)
    seen["lookup_rows"] = int((grad.abs().sum(1) > 0).sum())

    # the autograd pairs against their plain collectives, rank-specific
    # upstream gradients
    group = mesh.group("model")
    x = torch.as_tensor(r.standard_normal((2, 4, 3)), dtype=torch.float32)
    g_up = {dim: torch.as_tensor(r.standard_normal(
        (2, 8, 3) if dim == 1 else (2, 4, 3)), dtype=torch.float32)
        for dim in (0, 1)}
    xg = x.clone().requires_grad_()
    y = C.gather_from(xg, 1, group)
    assert torch.equal(y, C.all_gather_dim(x, 1, group))
    (gx,) = torch.autograd.grad(y, xg, g_up[1])
    assert torch.allclose(gx, C.all_reduce(g_up[1], group)[:, 4 * m:4 * m + 4])
    xg = x.clone().requires_grad_()
    y = C.reduce_scatter_to(xg, 1, group)
    assert torch.allclose(y, C.all_reduce(x, group)[:, 2 * m:2 * m + 2])
    up = g_up[0][:, :2]
    (gx,) = torch.autograd.grad(y, xg, up)
    assert torch.equal(gx, C.all_gather_dim(up, 1, group))
    xg = x.clone().requires_grad_()
    y = C.split_to(xg, 1, group)
    assert torch.equal(y, x[:, 2 * m:2 * m + 2])
    (gx,) = torch.autograd.grad(y, xg, up)
    assert torch.equal(gx, C.all_gather_dim(up, 1, group))
    for op, fwd, bwd in (
            (C.copy_to, x, C.all_reduce(g_up[0], group)),
            (C.reduce_from, C.all_reduce(x, group), g_up[0]),
            (C.first_rank_grad, x, g_up[0] if m == 0 else 0 * g_up[0]),
            (C.first_rank_value, x if m == 0 else 0 * x, g_up[0])):
        xg = x.clone().requires_grad_()
        y = op(xg, group)
        assert torch.equal(y, fwd), op
        (gx,) = torch.autograd.grad(y, xg, g_up[0])
        assert torch.equal(gx, bwd), op
    seen["pairs"] = True

    # shard then unshard: an LM training state, ZeRO moment specs
    cfg = get_smoke_config("granite-moe-3b-a800m")
    params = tree_from_numpy(numpy_params(cfg, 3), device="cpu")
    p_specs = shd.lm_param_shardings(cfg, transformer.abstract_params(cfg),
                                     mesh)
    o_specs = shd.opt_state_shardings(p_specs, mesh,
                                      transformer.abstract_params(cfg),
                                      zero=True)
    opt = adamw_init(params)
    opt = opt._replace(mu={k: v for k, v in params.items()})
    state, specs = dict(params=params, opt=opt), dict(params=p_specs,
                                                      opt=o_specs)
    local = shd.shard_tree(state, specs, mesh)
    back = shd.unshard_tree(local, specs, mesh)
    assert all(torch.equal(a, b) for a, b in zip(
        pytree.leaves(back), pytree.leaves(state), strict=True))
    seen["local_wq"] = tuple(local["params"]["layers"]["wq"].shape)
    seen["local_mu_wq"] = tuple(local["opt"].mu["layers"]["wq"].shape)
    # the reference's numpy tree, sharded and gathered on rank 0
    np_tree = numpy_params(cfg, 5)
    back = gather_lm_tree(cfg, shard_lm_tree(cfg, np_tree, mesh), mesh)
    if rank == 0:
        assert all(np.array_equal(a, b) for a, b in zip(
            pytree.leaves(back), pytree.leaves(np_tree), strict=True))
    else:
        assert back is None

    # a pod axis: the data axes are ("pod", "data"), one group
    pod = mesh_of((2, 1, 2), rank, world_size, init_method)
    assert pod.coords == dict(pod=d, data=0, model=m)
    g = C.all_gather_dim(torch.tensor([rank]), 0,
                         pod.group(("pod", "data")))
    assert g.tolist() == [m, 2 + m]
    assert pod.coord(("pod", "data")) == d and pod.extent(("pod",
                                                            "data")) == 2
    seen["pod"] = True
    return seen

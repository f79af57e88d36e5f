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


def gnn_cases(rank, world_size, init_method, cases):
    """For each case ``{cfg (GNNConfig fields), dims, params, batch,
    step}``: the edge-parallel loss (``dist.gnn_sharded``) on this rank's
    piece of the numpy batch and its gradient summed over the data axes;
    with ``step`` (AdamW settings) also one ``make_train_step`` step
    that cuts its own piece (``share``).  Rank 0 returns the loss, every
    gradient leaf and the stepped leaves (jax's leaf order); every rank
    its loss."""
    from repro_torch.dist import gnn_sharded
    from repro_torch.dist.sharding import gnn_param_shardings
    from repro_torch.models.convert import tree_from_numpy
    from repro_torch.models.gnn import GNNConfig
    from repro_torch.testing import to_torch
    from repro_torch.train import pytree
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import (make_train_step, sum_over_data,
                                         value_and_grad)
    out = []
    for case in cases:
        mesh = mesh_of(case["dims"], rank, world_size, init_method)
        cfg = GNNConfig(**case["cfg"])
        params = tree_from_numpy(case["params"], device="cpu")
        full = to_torch(case["batch"], "cpu")
        loss_fn = gnn_sharded.make_sharded_gnn_loss(cfg, mesh, full)
        local = gnn_sharded.local_batch(cfg, full, mesh)
        loss, grads = value_and_grad(loss_fn)(params, local)
        grads = sum_over_data(grads, mesh, None)
        res = dict(loss=float(loss), grads=None, stepped=None)
        if case.get("step"):
            step = make_train_step(
                loss_fn, AdamWConfig(**case["step"]), mesh=mesh,
                param_specs=gnn_param_shardings(params, mesh),
                share=partial(gnn_sharded.local_batch, cfg, mesh=mesh))
            p, _, m = step(params, adamw_init(params), full)
            res["stepped"] = ([x.numpy() for x in pytree.leaves(p)],
                              float(m["grad_norm"]))
        if rank == 0:
            res["grads"] = [g.numpy() for g in pytree.leaves(grads)]
        out.append(res)
    return out


def _recsys_state(cfg, params_np, mesh, zero, dtype=torch.float32):
    """This rank's pieces of a numpy DCN-v2 tree and the specs."""
    from repro_torch.dist.sharding import (opt_state_shardings,
                                           recsys_param_shardings,
                                           shard_tree)
    from repro_torch.models.convert import abstract_recsys, recsys_from_numpy
    shapes = abstract_recsys(cfg)
    p_specs = recsys_param_shardings(shapes, mesh)
    o_specs = opt_state_shardings(p_specs, mesh, shapes, zero=zero)
    full = recsys_from_numpy(cfg, params_np, device="cpu", dtype=dtype)
    return full, shard_tree(full, p_specs, mesh), p_specs, o_specs


def recsys_cases(rank, world_size, init_method, cases):
    """For each case ``{dims, zero, dtype, params, batch, serve,
    retrieval}`` (DCN-v2 smoke): the mesh's ``train_loss`` and every
    gradient leaf (summed over the data axes, ZeRO-scattered where
    ``zero``, gathered in full); the mesh's ``forward`` on the serve
    batch (each data rank its rows, gathered) and ``serve_retrieval``;
    whether the serve lookups and logits are bit-equal to one process on
    the same weights; on each rank whether its table gradient is zero
    outside the rows the batch names, and whether ``init_recsys(...,
    mesh=)`` keeps the meshless draws' rows.  Rank 0 returns the numbers;
    every rank its flags."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.dist.collectives import all_gather_dim
    from repro_torch.dist.sharding import data_axes, unshard
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.models import recsys
    from repro_torch.models.layers import cast_for_compute
    from repro_torch.train import pytree
    from repro_torch.train.steps import (data_share, sum_over_data,
                                         value_and_grad)
    cfg = get_smoke_config("dcn-v2")
    out = []
    for case in cases:
        mesh = mesh_of(case["dims"], rank, world_size, init_method)
        dtype = getattr(torch, case["dtype"])
        full, params, p_specs, o_specs = _recsys_state(
            cfg, case["params"], mesh, case["zero"])
        batch = {k: data_share(torch.as_tensor(v), mesh)
                 for k, v in case["batch"].items()}
        before = embedding_bag.launches
        loss, grads = value_and_grad(partial(
            recsys.train_loss, cfg, compute_dtype=dtype, mesh=mesh))(
            params, batch)
        # the rows this rank's shard holds that no id of the whole batch
        # names get no gradient (the step's sum over data adds zeros)
        rows = params["table"].shape[0]
        off = mesh.coord("model") * rows
        ids = torch.as_tensor(case["batch"]["sparse"]).long()
        gid = torch.where(ids >= 0, ids + recsys.table_offsets(cfg)[None],
                          -1).reshape(-1)
        named = torch.zeros(rows, dtype=torch.bool)
        here = (gid >= off) & (gid < off + rows)
        named[gid[here] - off] = True
        untouched = bool((grads["table"][~named] == 0).all())
        grads = sum_over_data(grads, mesh, p_specs, o_specs)
        g_full = [unshard(g.float(), s, mesh).numpy() for g, s in zip(
            pytree.leaves(grads), pytree.leaves(o_specs.mu), strict=True)]
        # serving: bf16 weights, each data rank its rows of the batch
        sp = cast_for_compute(params, torch.bfloat16)
        one = cast_for_compute(full, torch.bfloat16)
        serve = {k: torch.as_tensor(v) for k, v in case["serve"].items()}
        mine = {k: data_share(v, mesh) for k, v in serve.items()}
        feats = recsys.sparse_features(cfg, sp, mine["sparse"], mesh)
        logits = recsys.forward(cfg, sp, mine, mesh=mesh)
        group = mesh.group(data_axes(mesh))
        logits_all = all_gather_dim(logits.float(), 0, group)
        feats_equal = torch.equal(
            feats, recsys.sparse_features(cfg, one, mine["sparse"]))
        logits_equal = torch.equal(logits, recsys.forward(cfg, one, mine))
        retr = {k: torch.as_tensor(v) for k, v in case["retrieval"].items()}
        scores = recsys.serve_retrieval(cfg, sp, retr, mesh=mesh)
        scores_equal = torch.equal(scores,
                                   recsys.serve_retrieval(cfg, one, retr))
        # the launcher's initialisation on the mesh: the meshless draws'
        # rows (the f32 training tree)
        from repro_torch.dist.sharding import shard_tree
        from repro_torch.models.convert import init_recsys
        init_equal = all(torch.equal(a, b) for a, b in zip(
            pytree.leaves(init_recsys(cfg, 0, "cpu", torch.float32, mesh)),
            pytree.leaves(shard_tree(init_recsys(cfg, 0, "cpu",
                                                 torch.float32), p_specs,
                                     mesh)), strict=True))
        res = dict(untouched=untouched, feats_equal=feats_equal,
                   init_equal=init_equal,
                   logits_equal=logits_equal, scores_equal=scores_equal,
                   launches=embedding_bag.launches - before,
                   local_rows=rows)
        if rank == 0:
            res.update(loss=float(loss), grads=g_full,
                       logits=logits_all.float().numpy(),
                       scores=scores.numpy())
        out.append(res)
    return out


def compression_cases(rank, world_size, init_method, cases):
    """For each case ``{dims, zero, params, batches, opt}`` (DCN-v2 smoke,
    f32): each rank quantizes its pieces of a gradient tree (``grads``,
    numpy, the full leaves every rank is handed) under the layout the
    step leaves them in (the moment specs: model-sharded rows, ZeRO
    slices), gathered; and with ``batches``, ``make_train_step(
    compress_grads=True)`` on the mesh, its losses and final params
    gathered.  Rank 0 returns them."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import rng
    from repro_torch.dist.sharding import shard, unshard
    from repro_torch.models import recsys
    from repro_torch.train import pytree
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import _compress_tree, make_train_step
    cfg = get_smoke_config("dcn-v2")
    out = []
    for case in cases:
        mesh = mesh_of(case["dims"], rank, world_size, init_method)
        full, params, p_specs, o_specs = _recsys_state(
            cfg, case["params"], mesh, case["zero"])
        key = rng.PRNGKey(case["key"])
        res = {}
        if "grads" in case:
            g_specs = pytree.leaves(o_specs.mu)
            pieces = [shard(torch.as_tensor(g), s, mesh) for g, s in
                      zip(pytree.leaves(case["grads"]), g_specs,
                          strict=True)]
            tdef = pytree.flatten(case["grads"])[1]
            q = _compress_tree(pytree.unflatten(tdef, pieces), key, mesh,
                               o_specs.mu)
            res["quantized"] = [unshard(x, s, mesh).numpy() for x, s in
                                zip(pytree.leaves(q), g_specs, strict=True)]
        if "batches" in case:
            step = make_train_step(partial(recsys.train_loss, cfg,
                                           compute_dtype=torch.float32,
                                           mesh=mesh),
                                   AdamWConfig(**case["opt"]),
                                   compress_grads=True, mesh=mesh,
                                   param_specs=p_specs, state_specs=o_specs)
            opt = adamw_init(params, mesh, p_specs, o_specs)
            losses = []
            for i, b in enumerate(case["batches"]):
                params, opt, m = step(params, opt,
                                      {k: torch.as_tensor(v)
                                       for k, v in b.items()},
                                      rng.PRNGKey(case["key"] + i))
                losses.append(float(m["loss"]))
            res["losses"] = losses
            res["params"] = [unshard(x, s, mesh).numpy() for x, s in zip(
                pytree.leaves(params), pytree.leaves(p_specs), strict=True)]
        out.append(res if rank == 0 else None)
    return out


def pipeline_cases(rank, world_size, init_method, case):
    """``gpipe_forward`` of ``tanh(h @ W)`` stages on the case's mesh
    (the stage count on ``"pod"``), and the ``ValueError`` of a stack
    one stage short; then ``ppermute``, ``psum`` and ``divide_grad``
    under autograd over the pod group, with rank-specific inputs and
    upstream gradients.  Every rank returns its output and what it
    saw."""
    from repro_torch.dist import collectives as C
    from repro_torch.dist.pipeline import gpipe_forward
    mesh = mesh_of(case["dims"], rank, world_size, init_method)
    group, pod = mesh.group("pod"), mesh.coord("pod")
    n = mesh.extent("pod")

    def of(p, salt):
        return torch.arange(6, dtype=torch.float32).reshape(2, 3) * (
            p + 1) + salt
    seen = {}
    for shift in (1, -1, 2):
        x = of(pod, 0.5).requires_grad_()
        y = C.ppermute(x, group, shift)
        (g,) = torch.autograd.grad(y, x, of(pod, 0.25))
        seen[f"ppermute {shift}"] = (
            torch.equal(y, of((pod - shift) % n, 0.5))
            and torch.equal(g, of((pod + shift) % n, 0.25)))
    x = of(pod, 0.5).requires_grad_()
    y = C.psum(x, group)
    (g,) = torch.autograd.grad(y, x, of(pod, 0.25))
    seen["psum"] = (torch.equal(y, sum(of(p, 0.5) for p in range(n)))
                    and torch.equal(g, sum(of(p, 0.25) for p in range(n))))
    x = of(pod, 0.5).requires_grad_()
    y = C.divide_grad(x, 4)
    (g,) = torch.autograd.grad(y, x, of(pod, 0.25))
    seen["divide_grad"] = torch.equal(y, x) and torch.equal(
        g, of(pod, 0.25) / 4)
    x = of(pod, 0.5)
    seen["pmax"] = torch.equal(C.pmax(x, group), of(n - 1, 0.5))
    ws, xs = torch.as_tensor(case["ws"]), torch.as_tensor(case["xs"])
    out = gpipe_forward(lambda w, h: torch.tanh(h @ w), ws, xs, mesh)
    try:
        gpipe_forward(lambda w, h: h, ws[1:], xs, mesh)
        raised = None
    except ValueError as e:
        raised = str(e)
    return dict(out=out.numpy(), raised=raised, seen=seen)


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def serve_cases(rank, world_size, init_method, cases):
    """For each case ``{arch, replace, dims, tokens, cache_len, steps,
    seq_axes, reference}``: f32 ``transformer.prefill`` and
    ``decode_step`` with ``mesh=`` on this rank's pieces against the
    same calls without a mesh on the whole tree (every rank runs both),
    and against ``reference``, the reference's global arrays of the same
    readings (``torch_specs_common.reference_lm_runs``).  Prefill: the
    rows' logits and this rank's piece of the cache (the reference's
    prefill cache specs); decode, from the meshless prefill's cache cut
    to the flash-decoding layout (sequence over ``seq_axes``): the rows'
    logits and the cache piece after each of ``steps`` steps.  Returns
    each reading's relative L2 error against one process (``errs``) and
    against the reference (``ref_errs``), and this rank's coordinates."""
    from repro_torch.dist.sharding import P, data_axes, n_data, shard
    from repro_torch.models import transformer
    from repro_torch.models.convert import numpy_params, shard_lm_tree
    from repro_torch.models.convert import tree_from_numpy
    f32 = torch.float32
    out = []
    for case in cases:
        mesh = mesh_of(case["dims"], rank, world_size, init_method)
        cfg = lm_config(case)
        params_np = numpy_params(cfg, seed=0)
        full = tree_from_numpy(params_np, device="cpu")
        local = shard_lm_tree(cfg, params_np, mesh)
        da, seq_axes = data_axes(mesh), tuple(case["seq_axes"])
        split = not set(seq_axes) & set(da)
        tokens = torch.as_tensor(case["tokens"])
        B = tokens.shape[0]
        rows = (slice(mesh.coord(da) * B // n_data(mesh),
                      (mesh.coord(da) + 1) * B // n_data(mesh))
                if split else slice(0, B))
        ref = case["reference"]
        errs, ref_errs = {}, {}

        def hold(name, got, want, ref_want, spec=None):
            ref_want = torch.as_tensor(ref_want)
            if spec is None:
                want, ref_want = want[rows], ref_want[rows]
            else:
                want = shard(want, spec, mesh)
                ref_want = shard(ref_want, spec, mesh)
            errs[name] = _rel(got, want)
            ref_errs[name] = _rel(got, ref_want)

        want, cache = transformer.prefill(cfg, full, tokens,
                                          case["cache_len"], f32)
        if split:            # a prefill's rows always split over data
            got, piece = transformer.prefill(cfg, local, tokens[rows],
                                             case["cache_len"], f32,
                                             mesh=mesh)
            hold("prefill_logits", got, want, ref["prefill"]["logits"])
            kv_spec = P(None, da, None,
                        "model" if cfg.n_kv_heads % mesh.shape["model"] == 0
                        else None, None)
            for k in ("k", "v"):
                hold(f"prefill_cache_{k}", piece[k], cache[k],
                     ref["prefill"][k], kv_spec)
        dec_spec = P(None, da if split else None, seq_axes, None, None)
        mine = dict(k=shard(cache["k"], dec_spec, mesh),
                    v=shard(cache["v"], dec_spec, mesh),
                    kv_len=cache["kv_len"])
        for step, tok in enumerate(case["steps"]):
            tok = torch.as_tensor(tok)
            want, cache = transformer.decode_step(cfg, full, cache, tok, f32)
            got, mine = transformer.decode_step(cfg, local, mine, tok[rows],
                                                f32, mesh=mesh,
                                                seq_axes=seq_axes)
            r = ref["decode"][step]
            hold(f"decode_{step}_logits", got, want, r["logits"])
            for k in ("k", "v"):
                hold(f"decode_{step}_cache_{k}", mine[k], cache[k], r[k],
                     dec_spec)
        out.append(dict(errs=errs, ref_errs=ref_errs,
                        coords=dict(mesh.coords)))
    return out


def specs_mesh_cases(rank, world_size, init_method, serve, grads):
    """``serve_cases`` then ``lm_grads`` in one spawn."""
    return dict(serve=serve_cases(rank, world_size, init_method, serve),
                grads=lm_grads(rank, world_size, init_method, grads))

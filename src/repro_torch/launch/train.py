"""Training launcher of the port: the LM and recsys families on synthetic
data, resumable (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch dcn-v2 \\
        --scale smoke --steps 20 --ckpt-dir build/train_run --device cpu

``--scale smoke`` uses the reduced config, ``--scale full`` the assigned
one.  The loop is ``train.fault_tolerance.run_resumable``: checkpoints
every ``--ckpt-every`` steps into ``--ckpt-dir``, resumes from the latest
manifest, bounded retry then skip-and-log.  It runs on the card unless
``--device cpu``.  Batches are the reference's ``synthetic_batch``
(numpy seed ``step * 1000 + attempt``), so both packages see the same
data.  An LM trains ``transformer.train_loss`` (f32 parameters and
AdamW state, bf16 compute) from ``convert.init_lm_params`` seed 0;
DCN-v2 ``recsys.train_loss`` from ``convert.init_recsys`` seed 0.

GNN archs exit with the reference's message
(``examples/motif_features_gnn.py``; ``chip_smoke.py`` phase
``motif_gnn`` runs that pipeline on the card).

Both families train on a model mesh with ``--mesh data=2,model=2`` (or
``pod=..,data=..,model=..``) and ``--backend nccl|gloo``: the launcher
spawns one process per rank (``launch.mesh.run_on_mesh``, a ``file://``
rendezvous under ``--ckpt-dir``), each holding its pieces of the
parameters (``lm_param_shardings``; DCN-v2's ``recsys_param_
shardings``: the table by rows over ``"model"``, looked up through the
EmbeddingBag kernel on each rank's rows) and its share of every
microbatch; ``--zero`` shards the AdamW moments over the data axes
(``opt_state_shardings(zero=True)``), ``--sp`` an LM's residual stream
over ``"model"`` along the sequence (the reference's ``residual_spec``).
Checkpoints hold the full tree, so a run resumes on any mesh shape or
none.  Without ``--mesh`` it runs in this process, as before.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch granite-moe-3b-a800m --steps 3 --mesh data=2,model=2 \
        --zero --sp --backend gloo --device cpu --ckpt-dir build/lm_mesh
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
from functools import partial

import numpy as np
import torch

GNN_EXIT = "use examples/motif_features_gnn.py for GNN archs"


def synthetic_batch(cfg, batch_size: int, seq_len: int, step: int,
                    device="cuda") -> dict:
    """The reference's synthetic batch (numpy seed ``step``) as tensors on
    ``device``: an LM's ``tokens`` / ``labels`` (int32, one random
    sequence shifted by one) and ``mask`` (f32 ones), or a recsys
    ``dense`` / ``sparse`` / ``label`` batch."""
    r = np.random.default_rng(step)
    if cfg.family == "lm":
        tok = r.integers(0, cfg.vocab, size=(batch_size, seq_len + 1))
        return dict(
            tokens=torch.as_tensor(tok[:, :-1], dtype=torch.int32,
                                   device=device),
            labels=torch.as_tensor(tok[:, 1:], dtype=torch.int32,
                                   device=device),
            mask=torch.ones((batch_size, seq_len), dtype=torch.float32,
                            device=device))
    if cfg.family != "recsys":
        raise ValueError(f"synthetic_batch: use family-specific drivers for "
                         f"{cfg.family}")
    dense = r.normal(size=(batch_size, cfg.n_dense))
    sparse = r.integers(0, min(cfg.table_sizes), (batch_size, cfg.n_sparse))
    label = r.integers(0, 2, batch_size)
    return dict(
        dense=torch.as_tensor(dense, dtype=torch.float32, device=device),
        sparse=torch.as_tensor(sparse, dtype=torch.int32, device=device),
        label=torch.as_tensor(label, dtype=torch.float32, device=device))


def opt_config(lr: float, steps: int):
    """The reference launcher's schedule: warmup over a tenth of the run
    (at least 2 steps), cosine decay to its end."""
    from ..train.optimizer import AdamWConfig
    return AdamWConfig(lr=lr, total_steps=steps,
                       warmup_steps=max(2, steps // 10))


def state_specs(cfg, mesh, zero: bool = False) -> dict:
    """The ``PartitionSpec`` of every leaf of an LM's or DCN-v2's training
    state on ``mesh``: ``{params, opt}`` (``lm_param_shardings`` or
    ``recsys_param_shardings``, ``opt_state_shardings``)."""
    from ..dist.sharding import (lm_param_shardings, opt_state_shardings,
                                 recsys_param_shardings)
    from ..models.convert import abstract_recsys
    from ..models.transformer import abstract_params
    if cfg.family == "lm":
        shapes = abstract_params(cfg)
        p = lm_param_shardings(cfg, shapes, mesh)
    else:
        shapes = abstract_recsys(cfg)
        p = recsys_param_shardings(shapes, mesh)
    return dict(params=p, opt=opt_state_shardings(p, mesh, shapes,
                                                  zero=zero))


def build(cfg, lr: float, steps: int, accum: int = 1, device="cuda",
          mark=None, mesh=None, zero: bool = False,
          compute_dtype=torch.bfloat16):
    """``(state, do_step)`` for ``run_resumable``: f32 weights from seed 0
    (an LM's ``init_lm_params`` tree, DCN-v2's ``init_recsys``) with a
    fresh AdamW state, and the step that trains them (``opt_config(lr,
    steps)``; ``mark`` as in ``make_train_step``).  The step leaves the
    state it is given intact, so a step that raises can be retried or
    skipped.  With ``mesh`` the state is this rank's pieces under
    ``state_specs(cfg, mesh, zero)`` and the step a rank's.  The forward
    computes in ``compute_dtype``."""
    from ..models import recsys, transformer
    from ..models.convert import init_lm_params, init_recsys
    from ..train.optimizer import adamw_init
    from ..train.steps import make_train_step
    specs = None if mesh is None else state_specs(cfg, mesh, zero)
    if cfg.family == "lm":
        params = init_lm_params(cfg, seed=0, device=device, mesh=mesh)
        loss_fn = partial(transformer.train_loss, cfg,
                          compute_dtype=compute_dtype, mesh=mesh)
    else:
        params = init_recsys(cfg, seed=0, device=device, dtype=torch.float32,
                             mesh=mesh)
        loss_fn = partial(recsys.train_loss, cfg,
                          compute_dtype=compute_dtype, mesh=mesh)
    step_fn = make_train_step(
        loss_fn, opt_config(lr, steps), accum_steps=accum, mark=mark,
        mesh=mesh, param_specs=specs and specs["params"],
        state_specs=specs and specs["opt"])

    def do_step(state, batch, step):
        p, o, metrics = step_fn(state["params"], state["opt"], batch)
        return dict(params=p, opt=o), {k: float(v)
                                       for k, v in metrics.items()}
    opt = (adamw_init(params) if mesh is None
           else adamw_init(params, mesh, specs["params"], specs["opt"]))
    return dict(params=params, opt=opt), do_step


def parse_mesh(text: str) -> dict:
    """``"data=2,model=2"`` / ``"pod=2,data=2,model=2"`` -> extents."""
    dims = {}
    for part in text.split(","):
        name, _, n = part.partition("=")
        dims[name.strip()] = int(n)
    if set(dims) not in ({"data", "model"}, {"pod", "data", "model"}):
        raise ValueError(f"--mesh {text!r}: give data=,model= (and pod=)")
    return dims


def train(cfg, opts: dict, mesh=None):
    """Run ``opts["steps"]`` resumable steps (``run_resumable``) of
    ``cfg`` from seed 0, on ``mesh`` if given; returns the report."""
    from ..train.fault_tolerance import run_resumable
    device = opts["device"] if mesh is None else mesh.device
    state, do_step = build(cfg, opts["lr"], opts["steps"], opts["accum"],
                           device, mesh=mesh, zero=opts["zero"],
                           compute_dtype=getattr(torch,
                                                 opts["compute_dtype"]))
    specs = None if mesh is None else state_specs(cfg, mesh, opts["zero"])
    _, report = run_resumable(
        do_step, state,
        next_batch=lambda step, attempt: synthetic_batch(
            cfg, opts["batch"], opts["seq"], step * 1000 + attempt, device),
        total_steps=opts["steps"], ckpt_dir=opts["ckpt_dir"],
        ckpt_every=opts["ckpt_every"], mesh=mesh, specs=specs)
    return report


def _rank_main(rank: int, world_size: int, init_method: str, cfg,
               opts: dict):
    """One rank of ``--mesh``: join the mesh, train, return the report."""
    from .mesh import make_host_mesh
    dims = opts["mesh"]
    if opts["device"] == "cpu":         # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    mesh = make_host_mesh(dims["data"], dims["model"], dims.get("pod", 0),
                          rank=rank, world_size=world_size,
                          init_method=init_method, backend=opts["backend"],
                          device=opts["device"])
    if opts["sp"]:
        from ..dist.sharding import data_axes
        if cfg.family != "lm":
            raise ValueError("--sp shards an LM's residual stream")
        if opts["seq"] % dims["model"]:
            raise ValueError(f"--sp: --seq {opts['seq']} does not divide "
                             f"over {dims['model']} model ranks")
        cfg = dataclasses.replace(cfg, residual_spec=(data_axes(mesh),
                                                      "model", None))
    return train(cfg, opts, mesh)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dcn-v2")
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="build/repro_torch_train")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    ap.add_argument("--compute-dtype", default="bfloat16",
                    choices=["bfloat16", "float32"],
                    help="the forward's compute dtype (float32: the checks "
                         "that hold a mesh run to a meshless one)")
    ap.add_argument("--mesh", default=None,
                    help="data=D,model=M (or pod=P,data=D,model=M): train "
                         "in D*M (*P) processes, one per rank")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="the mesh's torch.distributed backend (required "
                         "with --mesh; ranks sharing a card need gloo)")
    ap.add_argument("--zero", action="store_true",
                    help="shard the AdamW moments over the data axes")
    ap.add_argument("--sp", action="store_true",
                    help="shard the residual stream over model along the "
                         "sequence")
    args = ap.parse_args(argv)

    from ..configs import get_config, get_smoke_config

    cfg = (get_config(args.arch) if args.scale == "full"
           else get_smoke_config(args.arch))
    if cfg.family not in ("lm", "recsys"):
        raise SystemExit(GNN_EXIT)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass --device cpu to train on "
                           "the CPU)")
    opts = dict(vars(args))
    if args.mesh is None:
        if args.zero or args.sp or args.backend:
            raise SystemExit("--zero, --sp and --backend need --mesh")
        report = train(cfg, opts)
    else:
        if args.backend is None:
            raise SystemExit("--mesh needs --backend nccl or gloo")
        from .mesh import run_on_mesh
        opts["mesh"] = parse_mesh(args.mesh)
        os.makedirs(args.ckpt_dir, exist_ok=True)
        report = run_on_mesh(
            _rank_main, math.prod(opts["mesh"].values()),
            os.path.join(args.ckpt_dir, f"rendezvous_{os.getpid()}"),
            args=(cfg, opts))[0]
    losses = [m["loss"] for m in report.metrics]
    span = (f"loss {losses[0]:.4f} -> {losses[-1]:.4f}" if losses
            else "no step left to run")
    print(f"ran {report.steps_run} steps (resumed_from={report.resumed_from}"
          f", retries={report.retries}); {span}")


if __name__ == "__main__":
    main()

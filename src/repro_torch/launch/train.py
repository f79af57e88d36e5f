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
"""
from __future__ import annotations

import argparse
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


def build(cfg, lr: float, steps: int, accum: int = 1, device="cuda",
          mark=None):
    """``(state, do_step)`` for ``run_resumable``: f32 weights from seed 0
    (an LM's ``init_lm_params`` tree, DCN-v2's ``init_recsys``) with a
    fresh AdamW state, and the step that trains them (``opt_config(lr,
    steps)``; ``mark`` as in ``make_train_step``).  The step leaves the
    state it is given intact, so a step that raises can be retried or
    skipped."""
    from ..models import recsys, transformer
    from ..models.convert import init_lm_params, init_recsys
    from ..train.optimizer import adamw_init
    from ..train.steps import make_train_step
    if cfg.family == "lm":
        params = init_lm_params(cfg, seed=0, device=device)
        loss_fn = partial(transformer.train_loss, cfg)
    else:
        params = init_recsys(cfg, seed=0, device=device, dtype=torch.float32)
        loss_fn = partial(recsys.train_loss, cfg)
    step_fn = make_train_step(loss_fn, opt_config(lr, steps),
                              accum_steps=accum, mark=mark)

    def do_step(state, batch, step):
        p, o, metrics = step_fn(state["params"], state["opt"], batch)
        return dict(params=p, opt=o), {k: float(v)
                                       for k, v in metrics.items()}
    return dict(params=params, opt=adamw_init(params)), do_step


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
    args = ap.parse_args(argv)

    from ..configs import get_config, get_smoke_config
    from ..train.fault_tolerance import run_resumable

    cfg = (get_config(args.arch) if args.scale == "full"
           else get_smoke_config(args.arch))
    if cfg.family not in ("lm", "recsys"):
        raise SystemExit(GNN_EXIT)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass --device cpu to train on "
                           "the CPU)")
    state, do_step = build(cfg, args.lr, args.steps, args.accum,
                           args.device)
    state, report = run_resumable(
        do_step, state,
        next_batch=lambda step, attempt: synthetic_batch(
            cfg, args.batch, args.seq, step * 1000 + attempt, args.device),
        total_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every)
    losses = [m["loss"] for m in report.metrics]
    span = (f"loss {losses[0]:.4f} -> {losses[-1]:.4f}" if losses
            else "no step left to run")
    print(f"ran {report.steps_run} steps (resumed_from={report.resumed_from}"
          f", retries={report.retries}); {span}")


if __name__ == "__main__":
    main()

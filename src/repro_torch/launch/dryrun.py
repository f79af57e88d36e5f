"""Multi-pod dry run: count every (arch x shape x mesh) cell on the host
(the port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell on 512 placeholder devices.
Torch has nothing to compile ahead, so the port runs rank 0's step of
each cell (``launch.specs.build_cell``) on meta tensors of its local
shapes, on a layout of the production mesh (``launch.mesh.
make_production_layout``: ``(16, 16)`` single-pod, ``(2, 16, 16)``
multi-pod), under ``roofline.cost``'s counter.  No card and no process
group are needed, and nothing is allocated.  Usage:

    PYTHONPATH=src python -m repro_torch.launch.dryrun          # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape train_4k --mesh both --out results/dryrun

Per cell it records the memory dict (``roofline.analysis.analyze``),
the counted flops / bytes (the roofline's terms, flops by dtype), the
collectives (kinds, counts, operand bytes), the 10 heaviest ops by
bytes, and the wall time of the counted run (``trace_s``, in place of
the reference's ``lower_s`` / ``compile_s``) -- one JSON per cell under
``--out``, so a stopped sweep resumes where it stopped.  ``status`` is
``ok``, ``skip`` (with the config's reason) or ``error`` (with the
exception and its traceback).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback


def run_cell(arch: str, shape: str, mesh_name: str, out_dir: str,
             force: bool = False, mesh=None) -> dict:
    """One cell's record on the ``mesh_name`` production layout
    (``single`` / ``multi``), or on ``mesh`` (a layout mesh) under that
    name."""
    from ..configs import get_skips
    from ..roofline.analysis import analyze
    from ..roofline.breakdown import breakdown
    from .mesh import make_production_layout
    from .specs import build_cell

    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}__{shape}__{mesh_name}".replace("/", "_")
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    skip = get_skips(arch).get(shape)
    if skip:
        rec = dict(arch=arch, shape=shape, mesh=mesh_name, status="skip",
                   reason=skip)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec

    if mesh is None:
        mesh = make_production_layout(multi_pod=(mesh_name == "multi"))
    rec = dict(arch=arch, shape=shape, mesh=mesh_name, n_devices=mesh.size)
    try:
        cell = build_cell(arch, shape, mesh)
        t0 = time.perf_counter()
        rl, coll, memd, cost = analyze(cell, mesh)
        trace_s = time.perf_counter() - t0
        top, _ = breakdown(cost, top=10)
        rec.update(status="ok", kind=cell.kind, notes=cell.notes,
                   port_notes=cell.port_notes, runs_whole=cell.runs_whole,
                   trace_s=round(trace_s, 2), ops=cost.ops,
                   memory=memd, roofline=rl.to_dict(),
                   flops_by_dtype=cost.flops_by_dtype,
                   collectives=dict(total_bytes=coll.total_bytes,
                                    count=coll.count, by_kind=coll.by_kind),
                   top_ops=[dict(name=n, bytes=b, flops=fl, count=c)
                            for b, fl, c, n in top])
        print(f"[ok]   {tag}: {rl.bottleneck}-bound  "
              f"compute={rl.compute_s:.3e}s memory={rl.memory_s:.3e}s "
              f"coll={rl.collective_s:.3e}s  "
              f"temp={memd['temp_bytes'] / 2**30:.2f}GiB/dev  "
              f"(trace {rec['trace_s']}s)", flush=True)
    except Exception as e:  # noqa: BLE001 -- record the failure, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    from ..configs import ARCH_IDS, shapes_for

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])
    n_ok = n_fail = n_skip = 0
    for arch in archs:
        shapes = (list(shapes_for(arch)) if args.shape == "all"
                  else args.shape.split(","))
        for shape in shapes:
            for mesh_name in meshes:
                rec = run_cell(arch, shape, mesh_name, args.out,
                               force=args.force)
                st = rec["status"]
                n_ok += st == "ok"
                n_fail += st == "error"
                n_skip += st == "skip"
    print(f"\ndry-run done: {n_ok} ok, {n_fail} failed, {n_skip} skipped")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

"""Per-op byte / flop breakdown of one rank's step (the port of
``repro.roofline.breakdown``): which aten ops and kernels dominate a
cell's memory and compute terms.

    PYTHONPATH=src python -m repro_torch.roofline.breakdown granite-8b \\
        train_4k [single|multi] [bytes|flops]

Rows are the ``by_op`` table of ``roofline.cost``: one per aten op or
hand-written kernel name (and collective kind), summed over every call
of it; there are no loop trips to multiply (``roofline.cost``).
"""
from __future__ import annotations

import sys


def breakdown(cost, top: int = 25, sort_by: str = "bytes"):
    """``(top rows, all rows)``, each row ``(bytes, flops, count,
    name)``, sorted by ``sort_by`` (``"bytes"`` or ``"flops"``)."""
    rows = [(r["bytes"], r["flops"], r["count"], name)
            for name, r in cost.by_op.items()]
    col = 0 if sort_by == "bytes" else 1
    rows.sort(key=lambda r: -r[col])
    return rows[:top], rows


def main() -> None:
    arch, shape = sys.argv[1], sys.argv[2]
    mesh_kind = sys.argv[3] if len(sys.argv) > 3 else "single"
    sort_by = sys.argv[4] if len(sys.argv) > 4 else "bytes"

    from ..launch.mesh import make_production_layout
    from ..launch.specs import build_cell
    from .analysis import analyze

    mesh = make_production_layout(multi_pod=(mesh_kind == "multi"))
    cell = build_cell(arch, shape, mesh)
    _, _, _, cost = analyze(cell, mesh)
    rows, allrows = breakdown(cost, sort_by=sort_by)
    total_b = sum(r[0] for r in allrows)
    total_f = sum(r[1] for r in allrows)
    print(f"total bytes {total_b:.3e}  flops {total_f:.3e}\n")
    print(f"{'GB':>11} {'GF':>11} {'calls':>7}  op")
    for nb, fl, count, name in rows:
        print(f"{nb / 1e9:11.2f} {fl / 1e9:11.1f} {count:7d}  {name}")


if __name__ == "__main__":
    main()

"""Markdown roofline/dry-run tables from the per-cell JSON records (the
port of ``repro.roofline.report``: the same two tables, the same
format, from ``launch.dryrun``'s records).

    PYTHONPATH=src python -m repro_torch.roofline.report results/dryrun
"""
from __future__ import annotations

import json
import os
import sys


def load(out_dir: str) -> list[dict]:
    recs = []
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                recs.append(json.load(f))
    return recs


def fmt_bytes(b: float) -> str:
    return f"{b / 2**30:.2f}"


def dryrun_table(recs: list[dict], mesh: str) -> str:
    rows = ["| arch | shape | status | temp GiB/dev | args GiB/dev | "
            "collectives (count) | coll GiB moved |",
            "|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("mesh") != mesh:
            continue
        if r["status"] == "skip":
            rows.append(f"| {r['arch']} | {r['shape']} | SKIP | - | - | "
                        f"{r['reason'][:44]} | - |")
            continue
        if r["status"] == "error":
            rows.append(f"| {r['arch']} | {r['shape']} | **FAIL** | - | - | "
                        f"{r['error'][:44]} | - |")
            continue
        m = r["memory"]
        ck = r["collectives"]["by_kind"]
        kinds = ", ".join(f"{k}x{int(v['count'])}" for k, v in
                          sorted(ck.items()))
        rows.append(
            f"| {r['arch']} | {r['shape']} | ok | "
            f"{fmt_bytes(m['temp_bytes'])} | "
            f"{fmt_bytes(m['argument_bytes'])} | {kinds or '-'} | "
            f"{r['collectives']['total_bytes'] / 2**30:.2f} |")
    return "\n".join(rows)


def roofline_table(recs: list[dict], mesh: str = "single") -> str:
    rows = ["| arch | shape | compute s | memory s | collective s | "
            "bottleneck | MODEL_FLOPS/HLO | roofline frac |",
            "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("mesh") != mesh or r["status"] != "ok":
            continue
        rl = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {rl['compute_s']:.3e} | "
            f"{rl['memory_s']:.3e} | {rl['collective_s']:.3e} | "
            f"**{rl['bottleneck']}** | {rl['useful_ratio']:.2f} | "
            f"{rl['roofline_frac']:.2f} |")
    return "\n".join(rows)


def main() -> None:
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun"
    recs = load(out_dir)
    n_ok = sum(r["status"] == "ok" for r in recs)
    n_fail = sum(r["status"] == "error" for r in recs)
    n_skip = sum(r["status"] == "skip" for r in recs)
    print(f"## Dry-run: {n_ok} ok / {n_fail} failed / {n_skip} skipped\n")
    for mesh in ("single", "multi"):
        print(f"### mesh = {mesh}\n")
        print(dryrun_table(recs, mesh))
        print()
    print("## Roofline (single-pod)\n")
    print(roofline_table(recs, "single"))


if __name__ == "__main__":
    main()

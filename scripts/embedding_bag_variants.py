#!/usr/bin/env python3
"""Time the EmbeddingBag kernel against variants of itself, on the card.

    PYTHONPATH=src python3 scripts/embedding_bag_variants.py \\
        [--baseline OLD.cu] [--reps 20]        # needs a CUDA card and nvcc

Builds ``kernels/embedding_bag/csrc/embedding_bag.cu`` as it is and in
variants made by textual edits of it (streaming loads, streaming stores,
both), each into its own library under ``build/eb_variants/``, every
``nvcc`` started at once, and prints each build's registers and spills.
Then, on the lookups ``chip_smoke.py`` times (DCN-v2's serve_bulk in both
output modes, a mesh rank's lookup as in ``eb_rank_case``, the multi-hot
bags), it holds every variant's output equal to the kernel's, bit for
bit (they sum in the same order), and times each with CUDA events (mean
of ``--reps`` calls, L2 warm from the call before) in turns: the kernel,
the variants, the kernel again.  Beside them: bags per thread forced to
1 and 2 (one block a batch, as the wrapper launches), a persistent grid
(``PER_SM`` blocks an SM, each looping over batches), the kernel's own
duration under ``torch.profiler``, ``torch.index_select`` on serve_bulk's
ids, and at the rank's shapes the wrapper's host time a call, step by
step.  ``--baseline`` adds a kernel source of the earlier interface
(``embedding_bag_launch`` without the geometry arguments, as the first
version in the history has it), ``--compare NAME=FILE`` another source
of this interface.  One JSON object a line, the card's name and power
limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "src" / "repro_torch" / "kernels" / "embedding_bag"
          / "csrc" / "embedding_bag.cu")
OUT = ROOT / "build" / "eb_variants"

ONCE = "X ld_once(const X* p) {\n  return __ldg(p);"
STORE = "  *static_cast<uint4*>(p) = v;"
# variant -> (text, replacement) edits of the source, each found once
VARIANTS = {
    "loads_streaming": [(ONCE, ONCE.replace("__ldg", "__ldcs"))],
    "store_streaming": [(STORE, "  __stcs(static_cast<uint4*>(p), v);")],
}
VARIANTS["both_streaming"] = [*VARIANTS["loads_streaming"],
                              *VARIANTS["store_streaming"]]
# blocks an SM holds at once: 32 KB of ring a block (ptxas), 6 in 228 KB
PER_SM = 6
NEW_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 8 + [ctypes.c_void_p]
OLD_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build(baseline: str | None, compare: list[str]) -> dict:
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    sources = {"kernel": text}
    for spec in compare:
        name, path = spec.split("=", 1)
        sources[name] = Path(path).read_text()
    for name, edits in VARIANTS.items():
        v = text
        for old, new in edits:
            if v.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} found "
                                   f"{v.count(old)} times")
            v = v.replace(old, new)
        sources[name] = v
    if baseline:
        sources["baseline"] = Path(baseline).read_text()
    procs = {}
    for name, src in sources.items():
        (OUT / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build._SHARED),
             "-o", str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{report}")
        usage = _build.ptxas_usage(report)
        emit({"build": name, "ptxas": {
            e.split("embedding_bag_kernel")[-1][:40]: u
            for e, u in usage.items()}})
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.embedding_bag_launch.restype = ctypes.c_int
        if name == "baseline":
            lib.embedding_bag_launch.argtypes = OLD_ARGS
        else:
            lib.embedding_bag_launch.argtypes = NEW_ARGS
        libs[name] = lib
    return libs


def launcher(lib, old: bool, table, idx, w, out_dtype, bpt=None,
             grid=None):
    """A function that launches ``lib``'s kernel on these inputs into a
    fresh output and returns it, and its geometry: the wrapper's, or
    with ``bpt`` bags a thread (one block a batch), or ``grid`` blocks."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag.ops import (THREADS,
                                                       launch_geometry)
    V, d = table.shape
    B, bag = idx.shape
    flags = (int(table.dtype == torch.bfloat16)
             | int(idx.dtype == torch.int64) << 1 | 1 << 2
             | int(out_dtype != table.dtype) << 3)
    g = None if old else launch_geometry(B, d, bag, table.element_size(),
                                         True)
    if bpt:
        rounds = -(-B // (THREADS // g.tpr))
        g = g._replace(bpt=bpt, grid=-(-rounds // bpt))
    if grid:
        g = g._replace(grid=grid)
    wp = None if w is None else w.data_ptr()

    def run():
        out = torch.empty((B, d), dtype=out_dtype, device="cuda")
        s = torch.cuda.current_stream().cuda_stream
        args = (table.data_ptr(), idx.data_ptr(), wp, out.data_ptr(), V, d,
                B, bag, flags)
        rc = lib.embedding_bag_launch(*args, s) if old else \
            lib.embedding_bag_launch(*args, *g, s)
        _build.check(rc, "embedding_bag variant")
        return out
    return run, (None if g is None else g._asdict())


def cases():
    """(name, table, idx, weights, out dtype, bytes) of each lookup."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import recsys
    cfg = get_config("dcn-v2")
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = (torch.randn((cfg.v_total, cfg.embed_dim), generator=gen,
                         device="cuda").mul_(0.01).to(torch.bfloat16))
    B = 262_144
    gid = (cs.recsys_ids(cfg, B, np.random.default_rng(0))
           + recsys.table_offsets(cfg, "cuda")).reshape(-1, 1)
    n = gid.shape[0]
    yield ("serve_bulk", table, gid, None, torch.bfloat16,
           n * 8 + 2 * n * 32)
    yield ("serve_bulk f32 out", table, gid, None, torch.float32,
           n * 8 + n * 32 + n * 64)
    rows = cfg.v_total // 2
    rtable = table[:rows]
    sparse = synthetic_batch(cfg, 65_536, 0, 0, "cuda")["sparse"][:32_768]
    lid = recsys.local_ids((sparse.long() + recsys.table_offsets(
        cfg, "cuda")).reshape(-1, 1), 0, rows, cfg.v_total)
    n, valid = lid.shape[0], int((lid >= 0).sum())
    yield ("mesh rank", rtable, lid, None, torch.float32,
           n * 8 + valid * 32 + n * 64)
    for d in (16, 128):
        V, Bm, bag = 1_000_000, 65_536, 8
        tab = torch.randn((V, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        idx = torch.randint(0, V, (Bm, bag), generator=gen, device="cuda")
        idx[torch.rand((Bm, bag), generator=gen, device="cuda") < 0.3] = -1
        w = torch.randn((Bm, bag), generator=gen, device="cuda")
        valid = int((idx >= 0).sum())
        yield (f"multi-hot d {d}", tab, idx, w, torch.bfloat16,
               idx.numel() * 8 + valid * (4 + 2 * d) + Bm * d * 2)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="a kernel source of the earlier "
                    "interface (no geometry arguments)")
    ap.add_argument("--compare", action="append", default=[],
                    metavar="NAME=FILE", help="another kernel source of "
                    "this interface, timed beside the kernel")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("embedding_bag_variants: no CUDA device")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    emit({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()})
    libs = build(args.baseline, args.compare)
    for name, table, idx, w, odt, nbytes in cases():
        want = embedding_bag_ref(table, idx, w, out_dtype=odt)
        runs = {}
        for lname, lib in libs.items():
            runs[lname] = launcher(lib, lname == "baseline", table, idx, w,
                                   odt)
        if idx.shape[1] == 1:
            for bpt in (1, 2):
                runs[f"bpt {bpt}"] = launcher(libs["kernel"], False, table,
                                              idx, w, odt, bpt=bpt)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        runs["persistent"] = launcher(libs["kernel"], False, table, idx, w,
                                      odt, grid=PER_SM * sms)
        ref = runs["kernel"][0]()
        torch.cuda.synchronize()
        exact = idx.shape[1] == 1
        ok = torch.equal(ref, want) if exact else bool(
            torch.allclose(ref.float(), want.float(), rtol=1e-2, atol=1e-2))
        order = list(runs) + list(reversed(runs))
        ms = {k: [] for k in runs}
        for k in order:
            got = runs[k][0]()
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise RuntimeError(f"{name}: {k} differs from the kernel")
            ms[k].append(cs.cuda_ms(runs[k][0], args.reps))
        rec = {"case": name, "bags": idx.shape[0], "bag": idx.shape[1],
               "kernel_device_ms": cs.kernel_device_ms(
                   runs["kernel"][0], "embedding_bag_kernel", 20),
               "bytes": nbytes, "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3,
               "kernel_equals_plain_version": ok,
               "ms": ms,
               "geometry": {k: r[1] for k, r in runs.items()}}
        if name.startswith("serve_bulk") and odt == table.dtype:
            flat = idx.view(-1)
            rec["index_select_equal"] = torch.equal(
                torch.index_select(table, 0, flat), ref)
            rec["index_select_ms"] = cs.cuda_ms(
                lambda: torch.index_select(table, 0, flat), args.reps)
        if name == "mesh rank":
            def call():
                return embedding_bag(table, idx, out_dtype=odt)
            rec.update(wrapper_ms=cs.cuda_ms(call, args.reps),
                       profiler_kernel_ms=cs.kernel_device_ms(
                           call, "embedding_bag_kernel", 20),
                       wrapper_host_us=cs.host_us_per_call(call),
                       host_us_by_step=host_steps(table, idx, odt))
        emit(rec)


def host_steps(table, idx, odt) -> dict:
    """Host microseconds a call of each step of the wrapper takes (1000
    calls each; the launch itself 200, queued without a sync), beside
    the steps it avoids (a device context, ``current_stream()``)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    B, bag = idx.shape
    V, d = table.shape
    flags = 1 | 1 << 1 | 1 << 2 | 1 << 3
    g = ops.launch_geometry(B, d, bag, 2, True)
    out = torch.empty((B, d), dtype=odt, device="cuda")
    embedding_bag(table, idx, out_dtype=odt)   # built, loaded and typed
    fn = _build.library("embedding_bag").embedding_bag_launch
    s = torch.cuda.current_stream().cuda_stream

    def launch():
        return fn(table.data_ptr(), idx.data_ptr(), None, out.data_ptr(), V,
                  d, B, bag, flags, *g, s)

    def ctx():
        with torch.cuda.device(0):
            pass
    steps = {
        "check_inputs": lambda: ops._check_inputs(table, idx, None, odt),
        "contiguous": lambda: (table.contiguous(), idx.contiguous()),
        "empty": lambda: torch.empty((B, d), dtype=odt, device="cuda"),
        "data_ptr x3": lambda: (table.data_ptr(), idx.data_ptr(),
                                out.data_ptr()),
        "current_device": torch.cuda.current_device,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "geometry": lambda: ops.launch_geometry(B, d, bag, 2, True),
        "ctypes_launch": launch,
        "avoided: device_context": ctx,
        "avoided: current_stream": lambda: (
            torch.cuda.current_stream().cuda_stream),
    }
    got = {}
    for name, step in steps.items():
        n = 200 if name == "ctypes_launch" else 1000
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        got[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    return got


if __name__ == "__main__":
    main()

"""The port's roofline (``roofline/*``) and dry run (``launch.dryrun``):

* the H100 constants, and ``roofline_from`` on hand-computed terms;
* ``report.dryrun_table`` / ``roofline_table`` byte-equal to the
  reference's on the same records;
* ``roofline.cost``: its flops against ``FlopCounterMode`` on a chain of
  products, its bytes on a known op sequence (views free), ``alike``;
* each model kernel's shape-only path inside ``counting()``: the shape
  and dtype of its plain version's output on small CPU inputs, and the
  operations and bytes it reports; the flash backward's formula, and
  ``attended_pairs`` against the mask of ``ref.visible``;
* the layout collectives: shapes, the bytes they report, and a real
  tensor on a ``LayoutGroup`` raising;
* a dry-run record of every recsys and GNN cell on a ``(2, 4)`` layout
  (the LM cells: ``test_torch_roofline_lm.py``), and the CLI.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.roofline import report as ref_report
from repro_torch.configs import cells, get_config
from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.dist import collectives as coll
from repro_torch.dist.collectives import LayoutGroup
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.flash_attention.ops import (
    attended_pairs, flash_attention, flash_attention_grads_meta)
from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                     visible)
from repro_torch.kernels.segment_matmul.ops import segment_matmul
from repro_torch.kernels.segment_matmul.ref import segment_matmul_ref
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import layout_mesh
from repro_torch.models.attention import attention_flash
from repro_torch.roofline import analysis, report
from repro_torch.roofline.cost import alike, counting

ROOT = Path(__file__).resolve().parents[1]
MESH = (2, 4)
OTHER_CELLS = [(a, s) for a, s, _ in cells()
               if get_config(a).family != "lm"]


def test_h100_constants():
    assert analysis.PEAK_FLOPS["bfloat16"] == 989e12
    assert analysis.PEAK_FLOPS["float32"] == 67e12
    assert analysis.HBM_BW == 3.35e12
    assert analysis.LINK_BW == 450e9


def test_roofline_from_hand_computed_terms():
    coll_stats = analysis.CollectiveStats()
    coll_stats.add("all-reduce", 450_000_000)
    rl = analysis.roofline_from(
        {"flops": 989e9 + 67e9,
         "flops_by_dtype": {"bfloat16": 989e9, "float32": 67e9},
         "bytes accessed": 3.35e9}, coll_stats, 4, 1.056e12)
    assert rl.compute_s == pytest.approx(2e-3)      # 1 ms + 1 ms
    assert rl.memory_s == pytest.approx(1e-3)
    assert rl.collective_s == pytest.approx(1e-3)
    assert rl.bottleneck == "compute" and rl.step_s == rl.compute_s
    assert rl.roofline_frac == pytest.approx(1.0)
    assert rl.useful_ratio == pytest.approx(1.056e12 / (4 * 1.056e12))
    rl = analysis.roofline_from({"flops": 67e9, "flops_by_dtype":
                                 {"float32": 67e9}, "bytes accessed": 6.7e9},
                                analysis.CollectiveStats(), 1, 0.0)
    assert rl.bottleneck == "memory" and rl.step_s == pytest.approx(2e-3)
    assert rl.roofline_frac == pytest.approx(0.5)


def _records():
    rl = dict(compute_s=1.5e-3, memory_s=2.25e-2, collective_s=0.0,
              bottleneck="memory", useful_ratio=0.4567, roofline_frac=0.0667)
    ok = dict(arch="granite-8b", shape="train_4k", mesh="single",
              status="ok", memory=dict(temp_bytes=3 * 2**30 + 12345,
                                       argument_bytes=2**31),
              collectives=dict(total_bytes=5 * 2**29, count=3, by_kind={
                  "all-reduce": dict(bytes=1, count=2),
                  "all-gather": dict(bytes=1, count=1)}),
              roofline=rl)
    return [ok, dict(ok, mesh="multi"),
            dict(arch="gemma2-27b", shape="long_500k", mesh="single",
                 status="skip", reason="SKIP(full-attn): " + "x" * 60),
            dict(arch="dcn-v2", shape="serve_p99", mesh="single",
                 status="error", error="ValueError: " + "y" * 80),
            dict(ok, arch="dcn-v2", shape="serve_bulk",
                 collectives=dict(total_bytes=0, count=0, by_kind={}))]


def test_report_tables_equal_reference():
    recs = _records()
    for mesh in ("single", "multi"):
        assert report.dryrun_table(recs, mesh) == ref_report.dryrun_table(
            recs, mesh)
    assert report.roofline_table(recs) == ref_report.roofline_table(recs)


def test_cost_flops_match_flop_counter():
    g = torch.Generator().manual_seed(0)
    shapes = dict(a=(8, 16), w1=(16, 32), w2=(32, 4), b=(3, 8, 16),
                  c=(3, 16, 5), bias=(4,))

    def chain(t):
        x = t["a"] @ t["w1"]
        y = torch.addmm(t["bias"], x, t["w2"])
        z = torch.bmm(t["b"], t["c"])
        e = torch.einsum("bij,bjk->bik", t["b"], t["c"])
        return y.sum() + z.sum() + e.sum()

    real = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    with FlopCounterMode(display=False) as fc:
        chain(real)
    meta = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    with counting() as c:
        chain(meta)
    assert c.flops == fc.get_total_flops() > 0
    assert set(c.flops_by_dtype) == {"float32"}
    half = {k: v.to(torch.bfloat16) for k, v in meta.items()}
    with counting() as c:
        chain(half)
    assert c.flops_by_dtype == {"bfloat16": fc.get_total_flops()}


def test_cost_counts_matrix_vector_products():
    m = torch.empty((6, 5), device="meta")
    v = torch.empty((5,), device="meta")
    with counting() as c:
        m @ v                                       # aten.mv
        torch.addmv(torch.empty(6, device="meta"), m, v)
        v @ v                                       # aten.dot
    assert c.by_op["mv"]["flops"] == c.by_op["addmv"]["flops"] == 60
    assert c.by_op["dot"]["flops"] == 10 and c.flops == 130


def test_cost_bytes_on_known_ops():
    x = torch.empty((4, 8), device="meta")          # 128 bytes
    with counting() as c:
        y = x + 1                                   # 128 in, 128 out
        z = y.t()                                   # a view: free
        w = z.contiguous()                          # a copy: 128 + 128
        w.view(32).sum()                            # 128 in, 4 out
    assert c.bytes == 256 + 256 + 132
    assert "t" not in c.by_op and "view" not in c.by_op
    assert c.flops == 0.0 and c.ops == 3


def test_alike_counts_repeats_from_the_first():
    x = torch.empty((4, 8), device="meta")
    w = torch.empty((8, 8), device="meta")
    calls = []

    def body(x, w):
        calls.append(1)
        return torch.tanh(x @ w)
    with counting() as once:
        body(x, w)
    with counting() as c:
        outs = [alike("body", body, x, w) for _ in range(5)]
    assert len(calls) == 2                  # once above, once in alike
    assert c.flops == 5 * once.flops and c.bytes == 5 * once.bytes
    assert c.by_op["mm"]["count"] == 5
    assert all(o.shape == (4, 8) and o.is_meta for o in outs)


def _pairs(Sq, Skv, causal, window):
    return int(visible(torch.arange(Sq), torch.arange(Skv), causal,
                       window).sum())


@pytest.mark.parametrize("dtype,D,window,cap", [
    (torch.float32, 16, 0, 0.0), (torch.bfloat16, 64, 5, 50.0)])
def test_flash_meta_path(dtype, D, window, cap):
    g = torch.Generator().manual_seed(1)
    B, S, Hq, Hkv = 2, 24, 4, 2
    q = torch.randn((B, S, Hq, D), generator=g).to(dtype)
    k, v = (torch.randn((B, S, Hkv, D), generator=g).to(dtype)
            for _ in range(2))
    kw = dict(causal=True, window=window, attn_softcap=cap)
    want = flash_attention_ref(q, k, v, **kw)
    before = flash_attention.launches
    with counting() as c:
        got = flash_attention(*(x.to("meta") for x in (q, k, v)), **kw)
    assert flash_attention.launches == before
    assert got.is_meta and got.shape == want.shape and got.dtype == dtype
    pairs = _pairs(S, S, True, window) * B * Hq
    name = ("flash_attention_sm90" if dtype == torch.bfloat16 and D == 64
            else "flash_attention")
    assert c.by_op[name] == dict(count=1, flops=4 * D * pairs,
                                 bytes=2 * q.nbytes + k.nbytes + v.nbytes)
    assert c.flops_by_dtype["sfu"] == pairs * (3 if cap else 1)


@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (24, 24, True, 0), (5, 9, True, 3), (9, 5, True, 0), (7, 7, False, 0),
    (6, 11, False, 4)])
def test_attended_pairs_are_the_visible_mask(Sq, Skv, causal, window):
    assert attended_pairs(Sq, Skv, causal, window) == _pairs(Sq, Skv, causal,
                                                             window)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (5, 50.0)])
def test_flash_backward_meta_path(window, cap):
    B, S, Hq, Hkv, D = 2, 24, 4, 2, 16
    q = torch.empty((B, S, Hq, D), device="meta", requires_grad=True)
    k, v = (torch.empty((B, S, Hkv, D), device="meta", requires_grad=True)
            for _ in range(2))
    with counting() as c:
        o = attention_flash(q, k, v, causal=True, window=window,
                            attn_softcap=cap)
        dq, dk, dv = torch.autograd.grad(o, (q, k, v), torch.empty_like(o))
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    pairs = _pairs(S, S, True, window) * B * Hq
    assert c.by_op["flash_attention backward"] == dict(
        count=1, flops=12 * D * pairs,
        bytes=4 * (3 * q.numel() + 2 * k.numel() + 2 * v.numel()))
    assert c.flops_by_dtype["sfu"] == 2 * pairs * (3 if cap else 1)
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_attention_grads_meta(q, k, v, causal=True, window=window,
                                   attn_softcap=cap)


def test_segment_matmul_meta_path():
    g = torch.Generator().manual_seed(2)
    x = torch.randn((24, 16), generator=g)
    w = torch.randn((3, 16, 8), generator=g)
    groups = torch.tensor([2, 0, 1], dtype=torch.int32)
    want = segment_matmul_ref(x, w, groups)
    with counting() as c:
        got = segment_matmul(x.to("meta"), w.to("meta"), groups.to("meta"))
    assert got.is_meta and got.shape == want.shape and got.dtype == x.dtype
    assert c.by_op["segment_matmul"] == dict(
        count=1, flops=2 * 24 * 16 * 8,
        bytes=x.nbytes + w.nbytes + want.nbytes)
    assert c.flops_by_dtype == {"float32": 2 * 24 * 16 * 8}


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_embedding_bag_meta_path(out_dtype):
    g = torch.Generator().manual_seed(3)
    table = torch.randn((50, 16), generator=g).to(torch.bfloat16)
    idx = torch.randint(-1, 50, (7, 3), generator=g)
    want = embedding_bag_ref(table, idx, out_dtype=out_dtype)
    with counting() as c:
        got = embedding_bag(table.to("meta"), idx.to("meta"),
                            out_dtype=out_dtype)
    assert got.is_meta and got.shape == want.shape
    assert got.dtype == want.dtype
    assert c.by_op["embedding_bag"] == dict(
        count=1, flops=7 * 3 * 16,
        bytes=idx.nbytes + 7 * 3 * 16 * 2 + want.nbytes)


def test_kernels_still_refuse_meta_outside_counting():
    x = torch.empty((8, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        segment_matmul(x, torch.empty((1, 4, 4), device="meta"),
                       torch.zeros(1, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        embedding_bag(x, torch.zeros((2, 1), dtype=torch.int64,
                                     device="meta"))


def test_layout_collectives_shapes_and_bytes():
    m = layout_mesh((2, 4))
    model, data = m.group("model"), m.group(("data",))
    assert (model.size, data.size, m.group(("data", "model")).size) == (
        4, 2, 8)
    x = torch.empty((6, 8), dtype=torch.bfloat16, device="meta")
    seen = []
    coll.LAYOUT_SINKS.append(lambda *a: seen.append(a))
    try:
        assert coll.all_gather_dim(x, 1, model).shape == (6, 32)
        assert coll.reduce_scatter_dim(x, 0, data).shape == (3, 8)
        assert coll.all_reduce(x, model).shape == (6, 8)
        assert coll.ppermute(x, data).shape == (6, 8)
        assert coll.gather_from(x, 0, model).shape == (24, 8)
        assert coll.psum_chunked(x, "model", 1, mesh=m).shape == (6, 8)
        assert coll.all_reduce(x, LayoutGroup(1)) is x     # moves nothing
    finally:
        coll.LAYOUT_SINKS.pop()
    nb = 6 * 8 * 2
    assert seen == [("all-gather", nb, 4 * nb), ("reduce-scatter", nb,
                                                  nb // 2),
                    ("all-reduce", nb, nb), ("collective-permute", nb, nb),
                    ("all-gather", nb, 4 * nb), ("all-reduce", nb, nb)]
    with counting() as c:
        coll.all_reduce(x, model)
    assert c.coll_by_kind == {"all-reduce": dict(bytes=nb, count=1)}
    assert c.bytes == 2 * nb


def test_layout_group_refuses_real_tensors():
    group = layout_mesh((2, 4)).group("model")
    for fn in (lambda t: coll.all_reduce(t, group),
               lambda t: coll.all_gather_dim(t, 0, group),
               lambda t: coll.reduce_scatter_dim(t, 0, group),
               lambda t: coll.ppermute(t, group)):
        with pytest.raises(ValueError, match="layout group takes meta"):
            fn(torch.zeros((4, 4)))


def _sage_minibatch_flops() -> float:
    """The products graphsage's minibatch step runs (f32): each block
    layer's two ``[n_dst, a] @ [a, b]`` forward, their two weight
    gradients, and the second layer's two input gradients (the first
    layer's inputs are features, which take none)."""
    sh, cfg = GNN_SHAPES["minibatch_lg"], get_config("graphsage-reddit")
    f1, f2 = sh["fanout"]
    n1, n2 = sh["batch_nodes"] * (1 + f1), sh["batch_nodes"]
    l1 = 2 * n1 * sh["d_feat"] * cfg.d_hidden
    l2 = 2 * n2 * cfg.d_hidden * sh["n_classes"]
    return 2 * l1 + 2 * l2 + 2 * l1 + 4 * l2


KEYS = {"arch", "shape", "mesh", "n_devices", "status", "kind", "notes",
        "trace_s", "memory", "roofline", "collectives"}


def hold_record(rec, arch, shape):
    assert rec["status"] == "ok", rec.get("traceback")
    assert KEYS <= set(rec)
    assert set(rec["memory"]) >= {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes"}
    assert set(rec["roofline"]) == set(analysis.Roofline.__dataclass_fields__)
    rl = rec["roofline"]
    assert rl["flops"] > 0 and rl["bytes_hbm"] > 0 and rl["step_s"] > 0
    if (arch, shape) == ("graphsage-reddit", "minibatch_lg"):
        # the reference's model_flops takes both layers over all 180,224
        # table nodes; the step computes each on its dst nodes only
        # (16,384, then 1,024), so it runs ~17x fewer products: held to
        # an independent count of them instead
        assert rl["flops"] == _sage_minibatch_flops()
        assert rl["useful_ratio"] > 1
    else:
        assert 0 < rl["useful_ratio"] <= 1.05, rl


@pytest.mark.parametrize("arch,shape", OTHER_CELLS,
                         ids=[f"{a}-{s}" for a, s in OTHER_CELLS])
def test_dryrun_record(tmp_path, arch, shape):
    rec = run_cell(arch, shape, "2x4", str(tmp_path), mesh=layout_mesh(MESH))
    hold_record(rec, arch, shape)
    assert json.loads((tmp_path / f"{arch}__{shape}__2x4.json").read_text()
                      ) == rec


def test_dryrun_and_report_cli(tmp_path):
    env = dict(PYTHONPATH=str(ROOT / "src"), PATH="/usr/bin:/bin")
    run = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
           str(tmp_path)]
    for arch, shape, done in (
            ("dcn-v2", "serve_p99", "2 ok, 0 failed, 0"),
            ("granite-8b", "long_500k", "0 ok, 0 failed, 2")):
        r = subprocess.run(run + ["--arch", arch, "--shape", shape, "--mesh",
                                  "both"], capture_output=True, text=True,
                           cwd=ROOT, env=env, timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
        assert f"dry-run done: {done} skipped" in r.stdout
    recs = ref_report.load(str(tmp_path))
    assert {(x["mesh"], x["status"]) for x in recs} == {
        ("single", "ok"), ("multi", "ok"), ("single", "skip"),
        ("multi", "skip")}
    assert {x["n_devices"] for x in recs if x["status"] == "ok"} == {256,
                                                                     512}
    r = subprocess.run([sys.executable, "-m", "repro_torch.roofline.report",
                        str(tmp_path)], capture_output=True, text=True,
                       cwd=ROOT, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.count("| arch | shape |") == 3
    assert ref_report.roofline_table(recs) in r.stdout

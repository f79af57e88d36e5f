"""``launch.specs.build_cell`` against the reference's on the production
``(data=16, model=16)`` mesh (the reference in a subprocess with 256 jax
host devices, the port on a layout mesh): one LM train cell
(granite-moe-3b-a800m, whose 24 query heads do not divide over 16 model
ranks), one prefill, one decode (gemma2-27b long_500k: the KV sequence
over data x model), one sharded GNN cell (graphcast, grid padded), one
recsys train and one recsys retrieval cell.

And the layouts those cells' steps run, on four gloo CPU ranks
(``tests/torch_dist_workers.py``): ``transformer.prefill`` and
``decode_step`` with ``mesh=`` against the same calls without one, and
against the reference's prefill and decode run in a subprocess on four
jax host devices under its own prefill and decode cells' shardings (the
flash-decoding layout), f32 within 1e-5 (relative L2 of the logits and
of each rank's cache piece) -- heads over ``model`` (granite-8b smoke,
``(2, 2)``), kv heads split inside a head (gemma2 smoke on ``(1, 4)``:
windows, softcaps, tied embeddings), query heads that do not divide (6
over 4: the attention block whole on every rank), the KV sequence over
``(data, model)`` for a batch of one, and an MoE (qwen2-moe smoke on
``(2, 2)``); decode steps cross a rank's boundary in the sequence.  The
whole-attention layout also trains: its loss and every gradient leaf on
``(1, 4)`` with sequence parallelism and on ``(2, 2)`` equal one
process's and the reference's ``value_and_grad`` under its train cell's
shardings on the same host mesh, f32 within 1e-5.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_production_layout, run_on_mesh
from repro_torch.launch.specs import build_cell
from repro_torch.models import transformer
from repro_torch.models.convert import numpy_params, tree_from_numpy
from repro_torch.testing import lm_batch
from repro_torch.train import pytree
from repro_torch.train.steps import value_and_grad
from torch_dist_workers import specs_mesh_cases
from torch_specs_common import (assert_same_cell, port_cell, reference_cells,
                                reference_lm_runs)

CELLS = [("granite-moe-3b-a800m", "train_4k"),
         ("qwen2-moe-a2.7b", "prefill_32k"),
         ("gemma2-27b", "long_500k"),
         ("graphcast", "ogb_products"),
         ("dcn-v2", "train_batch"),
         ("dcn-v2", "retrieval_cand")]
TOL = 1e-5
SIX_HEADS = dict(n_heads=6, n_kv_heads=2)


@pytest.fixture(scope="module")
def reference():
    return reference_cells((16, 16), ("data", "model"), CELLS)


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_production_cell_equals_reference(reference, arch, shape):
    assert_same_cell(port_cell(build_cell(arch, shape,
                                          make_production_layout())),
                     reference[f"{arch}|{shape}"])


def _serve_case(arch, dims, B, seq_axes=("model",), replace=None):
    r = np.random.default_rng(len(arch) + B)
    replace = replace or {}
    cfg = dataclasses.replace(get_smoke_config(arch), **replace)
    return dict(arch=arch, dims=dims, replace=replace,
                params=numpy_params(cfg, seed=0),
                tokens=r.integers(0, cfg.vocab, (B, 6)).astype(np.int32),
                cache_len=16, seq_axes=seq_axes,
                steps=[r.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
                       for _ in range(4)])


def _grad_case(dims, sp):
    cfg = dataclasses.replace(get_smoke_config("granite-8b"), **SIX_HEADS)
    return dict(arch="granite-8b", dims=dims, sp=sp, dtype="float32",
                replace=SIX_HEADS, params=numpy_params(cfg, seed=0),
                batch=lm_batch(cfg, np.random.default_rng(1), B=4))


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    serve = [_serve_case("granite-8b", (2, 2), 4),
             _serve_case("gemma2-27b", (1, 4), 2),
             _serve_case("granite-8b", (1, 4), 2, replace=SIX_HEADS),
             _serve_case("granite-8b", (2, 2), 1, ("data", "model")),
             _serve_case("qwen2-moe-a2.7b", (2, 2), 4)]
    grads = [_grad_case((1, 4), True), _grad_case((2, 2), False)]
    work = tmp_path_factory.mktemp("mesh_runs")
    ref = reference_lm_runs(serve, grads, work)
    for case, r in zip(serve, ref["serve"], strict=True):
        case["reference"] = r
    out = run_on_mesh(specs_mesh_cases, 4, str(work / "rendezvous"),
                      (serve, grads))
    return serve, grads, out, ref


SERVE_IDS = ["heads-over-model", "kv-split-in-head", "whole-attention",
             "seq-over-data-model", "moe"]


def _worst(out, i, key):
    errs = {}
    for rank in out:
        for k, v in rank["serve"][i][key].items():
            errs[k] = max(errs.get(k, 0.0), v)
    return errs


@pytest.mark.parametrize("i", range(len(SERVE_IDS)), ids=SERVE_IDS)
def test_meshed_serving_equals_one_process(mesh_runs, i):
    errs = _worst(mesh_runs[2], i, "errs")
    assert errs and max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("i", range(len(SERVE_IDS)), ids=SERVE_IDS)
def test_meshed_serving_equals_reference_cells(mesh_runs, i):
    serve, _, out, ref = mesh_runs
    errs = _worst(out, i, "ref_errs")
    assert errs and max(errs.values()) <= TOL, errs
    # the decode cell's layout is the one the port's case runs
    want = ("SP decode: KV sequence sharded over (data x model)"
            if "data" in serve[i]["seq_axes"]
            else "flash-decoding: KV sequence sharded over model")
    assert ref["serve"][i]["notes"] == want


def _hold_grads(got, loss, grads):
    assert got["loss"] == pytest.approx(loss, rel=TOL)
    for a, b in zip(got["grads"], grads, strict=True):
        assert np.linalg.norm(a - b) <= TOL * max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("i", range(2), ids=["1x4-sp", "2x2"])
def test_whole_attention_trains_as_one_process(mesh_runs, i):
    _, grads, out, _ = mesh_runs
    case = grads[i]
    cfg = dataclasses.replace(get_smoke_config("granite-8b"), **SIX_HEADS)
    params = tree_from_numpy(case["params"], device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in case["batch"].items()}
    loss, g = value_and_grad(lambda p, b: transformer.train_loss(
        cfg, p, b, compute_dtype=torch.float32))(params, batch)
    _hold_grads(out[0]["grads"][i], float(loss),
                [x.numpy() for x in pytree.leaves(g)])


@pytest.mark.parametrize("i", range(2), ids=["1x4-sp", "2x2"])
def test_whole_attention_trains_as_reference_cell(mesh_runs, i):
    _, _, out, ref = mesh_runs
    want = ref["grads"][i]
    _hold_grads(out[0]["grads"][i], want["loss"], want["grads"])

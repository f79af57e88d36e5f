"""The port stands alone: no jax, no repro, no silent CPU fallback.

* a fresh interpreter that imports ``repro_torch`` and every submodule
  has neither ``jax`` nor ``repro`` in ``sys.modules`` (a subprocess,
  because pytest workers already hold jax);
* no source file of the port, nor ``chip_smoke.py``, imports either, and
  no source file of the port reads the environment;
* the entry points default to the card and raise without one;
* each kernel wrapper takes its plain version only for CPU tensors and
  raises for any device it has no kernel for — it never catches a
  failed launch and falls back.
"""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(len(names), bad)
print(" ".join(names))
"""

# the modules of the stream-and-witness slice, among those imported
STREAM_SLICE = ("repro_torch.stream", "repro_torch.stream.replay",
                "repro_torch.stream.session", "repro_torch.stream.store",
                "repro_torch.stream.wal", "repro_torch.resilience.faultinject",
                "repro_torch.resilience.retry")
# the modules of the observability, retry-ladder and gateway slice
GATEWAY_SLICE = ("repro_torch.obs", "repro_torch.obs.clock",
                 "repro_torch.obs.registry", "repro_torch.obs.trace",
                 "repro_torch.resilience.atomic",
                 "repro_torch.resilience.errors", "repro_torch.gateway",
                 "repro_torch.gateway.io", "repro_torch.gateway.scheduler",
                 "repro_torch.gateway.state", "repro_torch.gateway.serve",
                 "repro_torch.core.engine", "repro_torch.api.session",
                 "repro_torch.api.serve", "repro_torch.launch.estimate")
# the modules of the training and GNN slice
TRAIN_SLICE = ("repro_torch.train", "repro_torch.train.pytree",
               "repro_torch.train.optimizer", "repro_torch.train.steps",
               "repro_torch.train.checkpoint",
               "repro_torch.train.fault_tolerance",
               "repro_torch.graphs.neighbor_sampler",
               "repro_torch.models.gnn", "repro_torch.models.recsys",
               "repro_torch.models.convert", "repro_torch.launch.train",
               "repro_torch.configs.gat_cora", "repro_torch.configs.gatedgcn",
               "repro_torch.configs.graphsage_reddit",
               "repro_torch.configs.graphcast", "repro_torch.testing")
# the modules of the estimator-mesh slice
MESH_SLICE = ("repro_torch.launch.mesh", "repro_torch.dist",
              "repro_torch.dist.sharding", "repro_torch.dist.collectives")
# the modules the model-side distribution slice extended
MODEL_MESH_SLICE = MESH_SLICE + (
    "repro_torch.models.transformer", "repro_torch.models.moe",
    "repro_torch.models.layers", "repro_torch.models.convert",
    "repro_torch.train.optimizer", "repro_torch.train.steps",
    "repro_torch.train.checkpoint", "repro_torch.train.fault_tolerance",
    "repro_torch.launch.train")
# the modules of the slice that finished ``dist/``: the edge-parallel GNN,
# DCN-v2's row-sharded table, GPipe and compression on sharded leaves
DIST_SLICE = ("repro_torch.dist.gnn_sharded", "repro_torch.dist.pipeline",
              "repro_torch.dist.collectives", "repro_torch.models.gnn",
              "repro_torch.models.recsys", "repro_torch.models.convert",
              "repro_torch.kernels.embedding_bag.ops",
              "repro_torch.train.steps", "repro_torch.core.rng",
              "repro_torch.launch.train")


def test_import_pulls_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.splitlines()
    count, bad = out[0].split(maxsplit=1)
    assert int(count) >= 92             # every module of the 12 slices
    assert bad.strip() == "[]"
    assert set(STREAM_SLICE) <= set(out[1].split())
    assert set(MESH_SLICE) <= set(out[1].split())
    assert set(GATEWAY_SLICE) <= set(out[1].split())
    assert set(TRAIN_SLICE) <= set(out[1].split())
    assert set(MODEL_MESH_SLICE) <= set(out[1].split())
    assert set(DIST_SLICE) <= set(out[1].split())


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_sources_import_neither_jax_nor_repro(path):
    for name in _imports(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), (path, name)


def test_chip_smoke_imports_neither_jax_nor_repro():
    """Every import of ``chip_smoke.py``, those inside its functions
    included, is of the standard library, torch or the port."""
    names = list(_imports(REPO / "chip_smoke.py"))
    assert "repro_torch" in {n.split(".")[0] for n in names}
    for name in names:
        assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), name


_ENV_NAMES = ("environ", "environb", "getenv", "getenvb", "putenv",
              "unsetenv")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_sources_read_no_environment(path):
    """No ``os.environ`` / ``os.getenv`` (or their imported names) in
    the port: every setting arrives as an argument."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Attribute):
            assert node.attr not in _ENV_NAMES, (path, node.lineno)
        elif isinstance(node, ast.Name):
            assert node.id not in _ENV_NAMES, (path, node.lineno)
        elif isinstance(node, ast.ImportFrom) and node.module == "os":
            assert not {a.name for a in node.names} & set(_ENV_NAMES), path


def _small_graph():
    from repro_torch import powerlaw_temporal_graph
    return powerlaw_temporal_graph(n=60, m=400, time_span=5000, seed=1)


def test_model_entry_points_default_to_the_card():
    """``init_lm``, ``init_lm_params``, ``lm_from_numpy``,
    ``init_recsys``, ``recsys_from_numpy``, ``init_gnn``,
    ``tree_from_numpy``, the training launcher and its
    ``synthetic_batch`` build on the card unless asked for the CPU."""
    import inspect
    from repro_torch.launch import train
    from repro_torch.models import convert
    for fn in (convert.init_lm, convert.init_lm_params,
               convert.lm_from_numpy, convert.init_recsys,
               convert.recsys_from_numpy, convert.init_gnn,
               convert.tree_from_numpy, train.build, train.synthetic_batch):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_entry_points_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults would run")
    from repro_torch import choose_tree, estimate, get_motif, preprocess
    from repro_torch.core.spanning_tree import candidate_trees
    from repro_torch.launch.estimate import main
    g = _small_graph()
    motif = get_motif("M4-2")
    with pytest.raises(RuntimeError, match="CUDA"):
        estimate(g, motif, 500, 64, chunk=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        choose_tree(g, motif, 500)
    with pytest.raises(RuntimeError, match="CUDA"):
        preprocess(g, candidate_trees(motif)[0], 500)
    with pytest.raises(RuntimeError, match="CUDA"):
        g.device_arrays()
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--graph", "powerlaw:n=60,m=400,time_span=5000,seed=1",
              "--motif", "M4-2", "--delta", "500", "--k", "64",
              "--chunk", "64"])


def test_mesh_defaults_to_the_card_and_raises_without_one():
    """``make_estimator_mesh()`` and the CLI's ``--mesh`` build on the
    card unless asked for the CPU; without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults would run")
    from repro_torch.launch.estimate import main
    from repro_torch.launch.mesh import make_estimator_mesh
    for shards in (None, 2):
        with pytest.raises(RuntimeError, match="CUDA"):
            make_estimator_mesh(shards)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--graph", "powerlaw:n=60,m=400,time_span=5000,seed=1",
              "--mesh", "2", "--device", "cuda"])


def test_model_mesh_defaults_to_the_card_and_raises_without_one(tmp_path):
    """``make_host_mesh`` / ``make_production_mesh`` put their ranks on
    the card unless asked for the CPU; without one they raise before a
    process group is joined, and the launcher's ``--mesh`` raises before
    it starts a process."""
    import inspect

    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.launch.train import main
    for fn in (make_host_mesh, make_production_mesh):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults would run")
    rdv = tmp_path / "rendezvous"
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh(2, 2, rank=0, world_size=4,
                       init_method=f"file://{rdv}", backend="gloo")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_production_mesh(rank=0, world_size=256,
                             init_method=f"file://{rdv}", backend="nccl")
    assert not torch.distributed.is_initialized() and not rdv.exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "granite-8b", "--mesh", "data=2,model=2",
              "--backend", "gloo", "--ckpt-dir", str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()


def test_stream_entry_points_default_to_the_card_and_raise_without_one(
        tmp_path):
    """``StreamingSession`` and the CLI's stream modes run on the card
    unless asked for the CPU; without one they raise at construction,
    before a WAL is opened or an edge is read."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults would run")
    from repro_torch.launch.estimate import main
    from repro_torch.stream import StreamingSession, StreamStore
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingSession(horizon=100)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingSession(StreamStore())
    wal = tmp_path / "never.wal"
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--serve", "--stream", "--wal", str(wal)])
    assert not wal.exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--stream-replay", str(tmp_path / "missing.npz")])


def test_wrappers_raise_on_devices_without_a_kernel():
    """``meta`` tensors stand in for a non-CPU request that cannot run.
    The explicit-query and given-draws ops take CPU tensors only, and
    the two kernel wrappers (dep-sum, keyed sampler) raise without
    counting a launch."""
    from repro_torch.kernels.interval_weight.ops import (dep_sum,
                                                         interval_weight)
    from repro_torch.kernels.tree_sampler.ops import (build_schedule,
                                                      tree_sampler,
                                                      tree_sampler_keyed)
    from repro_torch import get_motif
    from repro_torch.core.spanning_tree import candidate_trees
    from repro_torch.core.weights import preprocess

    meta = [torch.empty(n, dtype=torch.int64, device="meta")
            for n in (10, 11, 11, 4, 4, 4, 4, 4)]
    with pytest.raises(ValueError, match="no kernel for device"):
        interval_weight(*meta)

    g = _small_graph()
    tree = candidate_trees(get_motif("M4-2"))[0]
    dev = g.device_arrays("cpu")
    wts = preprocess(g, tree, 500, dev=dev, device="cpu")
    to_meta = {k: v.to("meta") for k, v in dev.items()}
    d = tree.deps[tree.root][0]
    ps = (wts.ps_acc_own[d.child].to("meta"),
          wts.ps_acc_prev[d.child].to("meta"))
    before = dep_sum.launches
    with pytest.raises(ValueError, match="no kernel for device"):
        dep_sum(to_meta, d, "own", 500, 500, ps, ps)
    assert dep_sum.launches == before

    for f in ("ps_win", "win_lo", "win_mid", "win_hi", "ps_acc_own",
              "ps_acc_prev", "ps_pair_own", "ps_pair_prev", "W_total"):
        setattr(wts, f, getattr(wts, f).to("meta"))
    S = tree.num_edges
    x = torch.zeros(8, dtype=torch.int64, device="meta")
    u = torch.zeros((8, S), dtype=torch.int64, device="meta")
    schedule = build_schedule(tree)
    with pytest.raises(ValueError, match="no kernel for device"):
        tree_sampler(schedule, tree.root, S, to_meta, wts, x, u, u)
    before = tree_sampler_keyed.launches
    with pytest.raises(ValueError, match="no kernel for device"):
        tree_sampler_keyed(schedule, tree.root, S, to_meta, wts,
                           torch.zeros(2, dtype=torch.int64, device="meta"),
                           8)
    assert tree_sampler_keyed.launches == before


def test_wrappers_reject_mixed_devices_and_dtypes():
    from repro_torch.kernels.interval_weight.ops import interval_weight
    cpu = [torch.zeros(n, dtype=torch.int64) for n in (10, 11, 11)]
    q = [torch.zeros(4, dtype=torch.int64) for _ in range(5)]
    with pytest.raises(ValueError, match="different devices"):
        interval_weight(*cpu, *q[:4], q[4].to("meta"))
    with pytest.raises(ValueError, match="int64"):
        interval_weight(cpu[0].int(), *cpu[1:], *q)
    # the CPU path answers with the plain version
    out = interval_weight(*cpu, *q)
    assert out.dtype == torch.int64 and out.shape == (4,)


def _wrapper(path: Path, name: str) -> ast.FunctionDef:
    tree = ast.parse(path.read_text())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


# (wrapper, its plain version, the function that launches, the library
# name it builds and checks): flash attention and segment_matmul dispatch
# between two kernels each, so their wrappers hand the name to one
# launching function; a wrapper lives in kernels/<its kernel>/ops.py
LAUNCHERS = [("dep_sum", "dep_sum_ref", "dep_sum", "'interval_weight'"),
             ("tree_sampler_keyed", "tree_sampler_ref",
              "tree_sampler_keyed", "'tree_sampler'"),
             ("flash_attention", "flash_attention_ref", "_launch", "kernel"),
             ("segment_matmul", "segment_matmul_ref", "_launch", "kernel"),
             ("embedding_bag", "embedding_bag_ref", "embedding_bag",
              "'embedding_bag'")]


@pytest.mark.parametrize("kernel,ref,launcher,lib", LAUNCHERS)
def test_cuda_path_launches_or_raises(kernel, ref, launcher, lib):
    """Statically (no CUDA tensor can be made here): the wrapper has no
    ``try``, reaches its plain version only under a ``device.type ==
    "cpu"`` test, and otherwise builds/loads its library, launches,
    checks the launch's error code and counts it (itself, or through
    the one launching function it calls, which has no ``try`` either)."""
    module = {"dep_sum": "interval_weight",
              "tree_sampler_keyed": "tree_sampler"}.get(kernel, kernel)
    ops = PORT / "kernels" / module / "ops.py"
    fn = _wrapper(ops, kernel)
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
    ref_calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Name) and n.func.id == ref]
    assert len(ref_calls) == 1
    cpu_ifs = [n for n in ast.walk(fn) if isinstance(n, ast.If)
               and "== 'cpu'" in ast.unparse(n.test)]
    assert len(cpu_ifs) == 1
    assert ref_calls[0] in list(ast.walk(cpu_ifs[0]))
    if launcher != kernel:
        assert f"return {launcher}(" in ast.unparse(fn)
        fn = _wrapper(ops, launcher)
        assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
    src = ast.unparse(fn)
    assert f"_build.library({lib})" in src
    assert f"_build.check(rc, {lib})" in src
    assert f"{kernel}.launches += 1" in src


def test_flash_attention_dispatches_between_two_built_kernels():
    """Both flash kernels are built sources, and ``kernel_for`` names
    one of them for every dtype and head dim the wrapper takes."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import (HEAD_DIMS,
                                                         kernel_for)
    names = {kernel_for(dt, d) for dt in (torch.float32, torch.bfloat16)
             for d in HEAD_DIMS}
    assert names == {"flash_attention", "flash_attention_sm90"}
    assert names <= set(_build.SOURCES)


def test_segment_matmul_dispatches_between_two_built_kernels():
    """Both grouped-GEMM kernels are built sources, and ``kernel_for``
    names one of them for every dtype and width the wrapper takes."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.segment_matmul.ops import kernel_for
    names = {kernel_for(dt, K, N) for dt in (torch.float32, torch.bfloat16)
             for K in (0, 36, 64, 1408, 2048) for N in (8, 100, 1408)}
    assert names == {"segment_matmul", "segment_matmul_sm90"}
    assert names <= set(_build.SOURCES)


def test_build_reads_only_repo_sources_for_sm90a():
    from repro_torch.kernels import _build
    for name, src in _build.SOURCES.items():
        assert src.is_file() and PORT in src.parents, name
        text = src.read_text()
        assert "Replaces the Pallas kernel" in text     # the source note
        assert "bounds it on the H100" in text
    assert _build.BUILD_DIR == REPO / "build" / "repro_torch"
    assert "build/" in (REPO / ".gitignore").read_text().split()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_graph_device_arrays_cpu_dtypes():
    g = _small_graph()
    dev = g.device_arrays("cpu")
    assert dev["t"].dtype == torch.int64 and dev["src"].dtype == torch.int32
    assert int(dev["m_real"]) == g.m
    assert np.array_equal(dev["t"].numpy(), g.t)

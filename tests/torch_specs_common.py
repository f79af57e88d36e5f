"""Shared pieces of ``tests/test_torch_specs*.py``: the reference's
``build_cell`` read in a subprocess (jax needs its host device count set
before it is imported), and both packages' cells reduced to plain
values that compare: kind, every argument's global shape and dtype by
its key path, every partition spec, ``donate_argnums``, ``model_flops``
and ``notes``; and the reference's LM cells run on a jax host mesh
(``reference_lm_runs``), for the port's meshed serving and training to
be held to."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={n}"
sys.path.insert(0, {src!r})
import json
import jax
from jax.sharding import NamedSharding
from repro.launch.specs import build_cell

mesh = jax.make_mesh({dims}, {axes})
keystr = jax.tree_util.keystr


def spec(x):
    if x is None:
        return None
    s = x.spec if isinstance(x, NamedSharding) else x
    return [list(e) if isinstance(e, tuple) else e for e in s]


def leaves(tree):
    is_leaf = lambda x: x is None or isinstance(x, NamedSharding)
    return [(keystr(p), spec(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]]


out = {{}}
for arch, shape in {cells}:
    c = build_cell(arch, shape, mesh)
    out[arch + "|" + shape] = dict(
        kind=c.kind,
        args=[(keystr(p), list(x.shape), str(x.dtype)) for p, x in
              jax.tree_util.tree_flatten_with_path(c.args)[0]],
        in_specs=leaves(c.in_shardings),
        out_specs=leaves(c.out_shardings),
        donate=list(c.donate_argnums), model_flops=c.model_flops,
        notes=c.notes)
print("JSON" + json.dumps(out))
"""


def reference_cells(dims, axes, cells, timeout: int = 600) -> dict:
    """The reference's cells on a ``dims`` host mesh, as plain values."""
    n = 1
    for d in dims:
        n *= d
    code = _REFERENCE.format(n=n, src=str(ROOT / "src"), dims=tuple(dims),
                             axes=tuple(axes),
                             cells=[tuple(c) for c in cells])
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, cwd=ROOT, env=env,
                       timeout=timeout)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    line = next(x for x in r.stdout.splitlines() if x.startswith("JSON"))
    return json.loads(line[4:])


def _spec(x):
    if x is None:
        return None
    return [list(e) if isinstance(e, tuple) else e for e in x.dims]


def _leaves(tree):
    from repro_torch.dist.sharding import PartitionSpec
    from repro_torch.train import pytree

    def walk(node, path, out):
        if node is None or isinstance(node, PartitionSpec):
            out.append((path, _spec(node)))
            return
        for p, leaf in pytree.flatten_with_paths(node):
            out.append((path + p, _spec(leaf)))
    out = []
    if isinstance(tree, tuple):
        for i, t in enumerate(tree):
            walk(t, f"[{i}]", out)
    else:
        walk(tree, "", out)
    return out


def port_cell(cell) -> dict:
    """A port ``Cell`` as the same plain values."""
    from repro_torch.train import pytree
    return dict(
        kind=cell.kind,
        args=[(p, list(x.shape), str(x.dtype).removeprefix("torch."))
              for p, x in pytree.flatten_with_paths(cell.args)],
        in_specs=_leaves(cell.in_shardings),
        out_specs=_leaves(cell.out_shardings),
        donate=list(cell.donate_argnums), model_flops=cell.model_flops,
        notes=cell.notes)


def _same_axes(spec):
    """A spec with every one-axis tuple entry written as the axis: jax
    stores ``P(("data",))``'s entry as ``"data"``, the same placement."""
    if spec is None:
        return None
    return [e[0] if isinstance(e, list) and len(e) == 1 else e
            for e in spec]


def assert_same_cell(got: dict, want: dict) -> None:
    assert got["kind"] == want["kind"]
    assert [tuple(a) for a in got["args"]] == [tuple(a) for a in
                                               want["args"]]
    for key in ("in_specs", "out_specs"):
        g = [(p, _same_axes(s)) for p, s in got[key]]
        w = [(p, _same_axes(s)) for p, s in want[key]]
        assert g == w, key
    assert got["donate"] == want["donate"]
    assert got["model_flops"] == want["model_flops"]
    assert got["notes"] == want["notes"]


_REFERENCE_RUNS = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={n}"
sys.path.insert(0, {src!r})
import pickle
from dataclasses import replace
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import get_smoke_config
from repro.dist.sharding import data_axes, n_data
from repro.launch import specs
from repro.models import transformer as jt
from repro.models.layers import softmax_xent

F32 = jnp.float32


def cell(arch, cfg, mesh, shape_name, **shape):
    # the reference's cell of ``shape`` for the smoke config
    specs.get_config = lambda a: cfg
    specs.shapes_for = lambda a: {{shape_name: shape}}
    specs.get_skips = lambda a: {{}}
    return specs.build_cell(arch, shape_name, mesh)


def auto_mesh(dims):
    # GSPMD's axes, which the reference's sharding constraints name
    return jax.make_mesh(tuple(dims), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def host(tree):
    return jax.tree.map(np.asarray, tree)


with open({inputs!r}, "rb") as f:
    serve, grads = pickle.load(f)
out = dict(serve=[], grads=[])
for case in serve:
    cfg = replace(get_smoke_config(case["arch"]), **case["replace"])
    mesh = auto_mesh(case["dims"])
    B, S = case["tokens"].shape
    C = case["cache_len"]
    pc = (cell(case["arch"], cfg, mesh, "prefill", kind="prefill",
               global_batch=B, seq_len=S) if B % n_data(mesh) == 0 else None)
    dc = cell(case["arch"], cfg, mesh, "decode", kind="decode",
              global_batch=B, seq_len=C)
    # a batch the data axes cannot split has no prefill cell: its
    # prefill runs unplaced and only feeds the decode cell its cache
    placed = (dict(in_shardings=pc.in_shardings,
                   out_shardings=pc.out_shardings) if pc else {{}})
    with mesh:
        prefill = jax.jit(lambda p, t: jt.prefill(cfg, p, t, C, F32),
                          **placed)
        decode = jax.jit(lambda p, c, t: jt.decode_step(cfg, p, c, t, F32),
                         in_shardings=dc.in_shardings,
                         out_shardings=dc.out_shardings)
        logits, cache = host(prefill(case["params"], case["tokens"]))
        rec = dict(prefill=dict(logits=logits, k=cache["k"], v=cache["v"]),
                   decode=[], notes=dc.notes)
        for tok in case["steps"]:
            logits, cache = host(decode(case["params"], cache, tok))
            rec["decode"].append(dict(logits=logits, k=cache["k"],
                                      v=cache["v"]))
    out["serve"].append(rec)
for case in grads:
    cfg = replace(get_smoke_config(case["arch"]), **case["replace"])
    mesh = auto_mesh(case["dims"])
    B, S = case["batch"]["tokens"].shape
    tc = cell(case["arch"], cfg, mesh, "train_4k" if case["sp"] else "train",
              kind="train", global_batch=B, seq_len=S)
    sp = "SP residuals" in tc.notes
    assert sp == case["sp"], tc.notes
    if sp:
        cfg = replace(cfg, residual_spec=(data_axes(mesh), "model", None))

    def loss(p, b):
        logits, aux = jt.forward(cfg, p, b["tokens"], compute_dtype=F32)
        return (softmax_xent(logits, b["labels"], b["mask"])
                + cfg.router_aux_coef * aux / max(cfg.n_layers, 1))
    with mesh:
        value, g = jax.jit(jax.value_and_grad(loss),
                           in_shardings=(tc.in_shardings[0],
                                         tc.in_shardings[2]))(
            case["params"], case["batch"])
    out["grads"].append(dict(loss=float(value), notes=tc.notes,
                             grads=[np.asarray(x, np.float32)
                                    for x in jax.tree.leaves(g)]))
with open({outputs!r}, "wb") as f:
    pickle.dump(out, f)
"""


def reference_lm_runs(serve, grads, work: Path, n_devices: int = 4,
                      timeout: int = 600) -> dict:
    """The reference's LM cells run on a host mesh of ``n_devices`` jax
    devices, in f32, on the same numpy trees and tokens as the port's
    cases: for each serve case ``{arch, replace, dims, params, tokens,
    cache_len, steps}``, its prefill under the prefill cell's shardings
    (the cache as the cell places it) and its decode steps under the
    decode cell's (the flash-decoding layout), each reading's global
    array; for each gradient case ``{arch, replace, dims, sp, params,
    batch}``, ``value_and_grad`` of the loss under the train cell's
    parameter and batch shardings (``train_4k``'s sequence-parallel
    residuals where ``sp``)."""
    import pickle
    inputs, outputs = work / "reference_in.pkl", work / "reference_out.pkl"
    with open(inputs, "wb") as f:
        pickle.dump((serve, grads), f)
    code = _REFERENCE_RUNS.format(n=n_devices, src=str(ROOT / "src"),
                                  inputs=str(inputs), outputs=str(outputs))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, cwd=ROOT, env=env,
                       timeout=timeout)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    with open(outputs, "rb") as f:
        return pickle.load(f)

"""The port's MoE LMs against ``repro.models.transformer`` on the same
weights (the reference's ``init_params``, norms perturbed from a numpy
seed) for the qwen2-moe-a2.7b and granite-moe-3b-a800m smoke configs:
``forward`` (logits and the summed aux), ``prefill`` (last logits, cache,
``kv_len``) and three ``decode_step``s.

In f32 the port is held to 1e-4 with its own routing.  In bf16 the two
frameworks round at other places, and routing is discontinuous: a
one-ulp difference in a router input flips a top-k choice whose two
candidates are nearly tied (the reference's own jitted and eager runs
disagree at such ties too), after which that token's output differs by
a whole expert.  So in bf16 the reference's routes are recorded (a
``jax.debug.callback`` in its ``route``) and handed to the port, which
computes everything else itself and is held to 5e-2, with the absolute
part scaled by the rms of the reference's output (as in
``test_torch_moe.py``); and wherever the port's own top-k differs from
the reference's, the test asserts that the port's own router saw a near
tie there (its k-th and (k+1)-th probabilities within ``TIE``).
"""
from __future__ import annotations

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import moe as jm
from repro.models import transformer as jt
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as tm
from repro_torch.models.convert import lm_from_numpy

ARCHS = ["qwen2-moe-a2.7b", "granite-moe-3b-a800m"]
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-4),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 5e-2)}
S, CACHE, STEPS = 20, 24, 3
TIE = 5e-3        # router probabilities this close count as a tie in bf16


def _setup(arch):
    jcfg = jax_smoke(arch)
    params = jax.tree.map(np.asarray,
                          jt.init_params(jcfg, jax.random.PRNGKey(1)))
    r = np.random.default_rng(4)
    for k in [k for k in params["layers"] if k.endswith("norm")]:
        params["layers"][k] = (params["layers"][k] + r.normal(
            0, 0.1, params["layers"][k].shape)).astype(np.float32)
    params["final_norm"] = (params["final_norm"] + r.normal(
        0, 0.1, params["final_norm"].shape)).astype(np.float32)
    model = lm_from_numpy(get_smoke_config(arch), params, device="cpu")
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab,
                                               (2, S + STEPS))
    return jcfg, jax.tree.map(jnp.asarray, params), model, tokens


@pytest.fixture
def routes(monkeypatch, request):
    """In bf16: the reference's (gates, experts) per ``route`` call, handed
    to the port's ``route`` in the same order; in f32: nothing."""
    if request.node.callspec.params["dtype"] != "bfloat16":
        return None
    queue = collections.deque()
    ref_route, port_route = jm.route, tm.route

    def record(cfg, h2, w):
        gates, experts, aux = ref_route(cfg, h2, w)
        jax.debug.callback(
            lambda g, e: queue.append((np.array(g), np.array(e))),
            gates, experts, ordered=True)
        return gates, experts, aux

    def pinned(cfg, h2, w):
        _, experts, aux = port_route(cfg, h2, w)
        g, e = queue.popleft()
        k = cfg.top_k
        own = torch.sort(experts, -1).values
        ref = torch.sort(torch.as_tensor(e).long(), -1).values
        flipped = (own != ref).any(-1)
        if flipped.any():
            probs = torch.softmax(h2.float() @ w.float(), -1)[flipped]
            top = torch.topk(probs, k + 1, -1).values
            gap = top[:, k - 1] - top[:, k]
            assert bool((gap < TIE).all()), f"route differs, gap {gap}"
        return torch.as_tensor(g), torch.as_tensor(e).long(), aux

    monkeypatch.setattr(jm, "route", record)
    monkeypatch.setattr(tm, "route", pinned)
    return queue


def _close(got, want, dtype, what):
    tol = DTYPES[dtype][2]
    want = np.asarray(want, np.float32)
    scale = float(np.sqrt(np.mean(want ** 2))) if dtype == "bfloat16" else 1
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol * scale,
                               rtol=tol, err_msg=what)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype, routes):
    jcfg, jp, model, tokens = _setup(arch)
    tdt, jdt, tol = DTYPES[dtype]
    want, jaux = jt.forward(jcfg, jp, jnp.asarray(tokens[:, :S]),
                            compute_dtype=jdt)
    got, aux = model.forward(torch.as_tensor(tokens[:, :S]),
                             compute_dtype=tdt)
    assert got.shape == (2, S, jcfg.vocab) and aux.dtype == torch.float32
    _close(got, want, dtype, "forward logits")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=tol)
    assert float(aux) > 0
    assert not routes                      # every recorded route consumed


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype, routes):
    jcfg, jp, model, tokens = _setup(arch)
    tdt, jdt, _ = DTYPES[dtype]
    want, jcache = jt.prefill(jcfg, jp, jnp.asarray(tokens[:, :S]), CACHE,
                              compute_dtype=jdt)
    got, cache = model.prefill(torch.as_tensor(tokens[:, :S]), CACHE,
                               compute_dtype=tdt)
    assert got.shape == (2, 1, jcfg.vocab)
    assert cache["kv_len"] == int(jcache["kv_len"]) == S
    _close(got, want, dtype, "prefill logits")
    for name in ("k", "v"):
        _close(cache[name], jcache[name], dtype, f"prefill cache {name}")
    for step in range(STEPS):
        tok = tokens[:, S + step:S + step + 1]
        want, jcache = jt.decode_step(jcfg, jp, jcache, jnp.asarray(tok),
                                      compute_dtype=jdt)
        got, cache = model.decode_step(cache, torch.as_tensor(tok),
                                       compute_dtype=tdt)
        assert cache["kv_len"] == int(jcache["kv_len"]) == S + step + 1
        _close(got, want, dtype, f"decode {step} logits")
        for name in ("k", "v"):
            _close(cache[name], jcache[name], dtype,
                   f"decode {step} cache {name}")
    assert not routes


def test_moe_param_count_and_layer_shapes():
    """The MoE layers carry the reference's weight names and shapes;
    Qwen1.5-MoE-A2.7B stores 15.15 B parameters (the reference's
    ``param_count``, which leaves out the 4 pad experts, gives 14.32 B)."""
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import layer_shapes
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jax_config(arch)
        assert cfg.e_pad == jcfg.e_pad
        shapes = layer_shapes(cfg)
        ref = jax.eval_shape(lambda: jt.init_params(
            jcfg, jax.random.PRNGKey(0)))["layers"]
        assert set(shapes) == set(ref)
        for name, shape in shapes.items():
            assert (cfg.n_layers, *shape) == ref[name].shape, name
    cfg = get_config("qwen2-moe-a2.7b")
    stored = (cfg.n_layers * sum(int(np.prod(s))
                                 for s in layer_shapes(cfg).values())
              + 2 * cfg.vocab * cfg.d_model + cfg.d_model)
    assert (round(jax_config("qwen2-moe-a2.7b").param_count() / 1e9, 2),
            round(stored / 1e9, 2)) == (14.32, 15.15)

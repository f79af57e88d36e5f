"""The port's MoE layer against ``repro.models.moe`` on the same inputs:
``capacity``, ``route`` (experts equal, gates 1e-6), ``dispatch_tables``
(slot tables equal, also when capacity drops tokens, so the drop order
is the reference's) and ``moe_mlp`` (output and aux) for both MoE smoke
configs, in f32 (1e-4) and bf16 (5e-2: bf16 rounds at other places in the
two frameworks).  The expert products go through the grouped-GEMM
wrapper, on the CPU its plain version.

In bf16 the absolute part of the tolerance is 5e-2 times the rms of the
reference output: a one-ulp difference in an intermediate (``silu``,
``g * u``) is proportional to that intermediate's size, and the outputs
are sums over ``d_expert`` terms whose scale (the reference's expert
init has fan-in ``E_pad``, so outputs reach ~50) can cancel to far below
it at single elements.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import moe as jm
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.segment_matmul.ops import segment_matmul
from repro_torch.models import moe as tm

ARCHS = ["qwen2-moe-a2.7b", "granite-moe-3b-a800m"]
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-4),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 5e-2)}
# capacity factor 8.0 (the smoke configs': no drops) and 0.5 (drops)
FACTORS = [None, 0.5]


def _setup(arch, factor, dtype, T=48):
    jcfg, cfg = jax_smoke(arch), get_smoke_config(arch)
    if factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=factor)
        cfg = dataclasses.replace(cfg, capacity_factor=factor)
    p = jax.tree.map(lambda a: np.asarray(a[0]), jm.init_moe_params(
        jcfg, jax.random.PRNGKey(2)))
    r = np.random.default_rng(3)
    h = r.standard_normal((2, T // 2, cfg.d_model)).astype(np.float32)
    tdt, jdt, _ = DTYPES[dtype]
    return (jcfg, cfg, {k: jnp.asarray(v, jdt) for k, v in p.items()},
            {k: torch.as_tensor(np.array(v)).to(tdt) for k, v in p.items()},
            jnp.asarray(h, jdt), torch.as_tensor(h).to(tdt))


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_equals_reference(arch):
    jcfg, cfg = jax_smoke(arch), get_smoke_config(arch)
    for T in (1, 2, 7, 48, 1000, 16384):
        assert tm.capacity(cfg, T) == jm.capacity(jcfg, T)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("arch", ARCHS)
def test_route_and_dispatch_equal_reference(arch, factor, dtype):
    jcfg, cfg, jp, tp, jh, th = _setup(arch, factor, dtype)
    T = th.shape[0] * th.shape[1]
    jg, je, jaux = jm.route(jcfg, jh.reshape(T, -1), jp["router"])
    tg, te, taux = tm.route(cfg, th.reshape(T, -1), tp["router"])
    assert np.array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    C = tm.capacity(cfg, T)
    js, jpos = jm.dispatch_tables(jcfg, je, C)
    ts, tpos = tm.dispatch_tables(cfg, te, C)
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(tpos.numpy(), np.asarray(jpos))
    kept = int((ts >= 0).sum())
    if factor is None:
        assert kept == T * cfg.top_k
    else:                                   # the dropping case drops
        assert kept < T * cfg.top_k


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_mlp_matches_reference(arch, factor, dtype):
    jcfg, cfg, jp, tp, jh, th = _setup(arch, factor, dtype)
    want, jaux = jm.moe_mlp(jcfg, jh, jp)
    before = segment_matmul.launches
    got, aux = tm.moe_mlp(cfg, th, tp)
    assert segment_matmul.launches == before          # CPU: plain version
    assert got.dtype == th.dtype and got.shape == th.shape
    tol = DTYPES[dtype][2]
    want = np.asarray(want, np.float32)
    scale = float(np.sqrt(np.mean(want ** 2))) if dtype == "bfloat16" else 1
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol * scale,
                               rtol=tol)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)

"""The port's LM building blocks against ``repro.models.layers`` on the
same numpy inputs, and its inits' determinism and statistics."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-6),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 1e-2)}


def _pair(a, dtype):
    tdt, jdt, _ = DTYPES[dtype]
    return torch.as_tensor(a).to(tdt), jnp.asarray(a, jdt)


def _close(got, want, dtype):
    tol = DTYPES[dtype][2]
    assert got.dtype == DTYPES[dtype][0]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("zero_centered", [True, False])
def test_rms_norm(dtype, zero_centered):
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 5, 48)).astype(np.float32) * 3
    w = r.standard_normal(48).astype(np.float32) * 0.3
    (tx, jx), (tw, jw) = _pair(x, dtype), _pair(w, dtype)
    _close(tl.rms_norm(tx, tw, zero_centered=zero_centered),
           jl.rms_norm(jx, jw, zero_centered=zero_centered), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope(dtype, theta):
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.array([0, 1, 2, 5, 8, 13, 100, 4095, 8191])
    tx, jx = _pair(x, dtype)
    _close(tl.apply_rope(tx, torch.as_tensor(pos), theta),
           jl.apply_rope(jx, jnp.asarray(pos), theta), dtype)
    np.testing.assert_allclose(tl.rope_frequencies(16, theta).numpy(),
                               np.asarray(jl.rope_frequencies(16, theta)),
                               rtol=1e-6)


@pytest.mark.parametrize("cap", [30.0, 50.0])
def test_softcap(cap):
    x = np.linspace(-400, 400, 1001).astype(np.float32)
    (tx, jx) = _pair(x, "float32")
    got = tl.softcap(tx, cap)
    _close(got, jl.softcap(jx, cap), "float32")
    assert float(got.abs().max()) <= cap


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_swiglu(dtype):
    r = np.random.default_rng(2)
    x, g, u, d = (r.standard_normal(s).astype(np.float32) * 0.5
                  for s in ((3, 4, 32), (32, 64), (32, 64), (64, 32)))
    pairs = [_pair(a, dtype) for a in (x, g, u, d)]
    got = tl.swiglu(*(p[0] for p in pairs))
    want = jl.swiglu(*(p[1] for p in pairs))
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_cast_for_compute_keeps_ints_and_same_dtype_tensors():
    w = torch.ones(3, dtype=torch.bfloat16)
    out = tl.cast_for_compute({"w": w, "f": torch.ones(2),
                               "i": torch.arange(2)}, torch.bfloat16)
    assert out["w"] is w
    assert out["f"].dtype == torch.bfloat16
    assert out["i"].dtype == torch.int64


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inits_are_deterministic_and_scaled(dtype):
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return (tl.dense_init((256, 512), g, dtype=dtype),
                tl.embed_init((300, 64), g, dtype=dtype))
    (w1, e1), (w2, e2), (w3, _) = draw(0), draw(0), draw(1)
    assert w1.dtype == e1.dtype == dtype
    assert torch.equal(w1, w2) and torch.equal(e1, e2)
    assert not torch.equal(w1, w3)
    wf = w1.float()
    # N(0, 1) cut at +-3 has std 0.9866; fan-in 256 scales by 1/16
    assert abs(float(wf.std()) - 0.9866 / 16) < 2e-3
    assert float(wf.abs().max()) <= 3 / 16 + 1e-3
    assert abs(float(e1.float().std()) - 0.02) < 1e-3

"""Building the port's LM from weights (no JAX counterpart).

* ``lm_from_numpy`` takes the reference's ``init_params`` pytree as
  numpy arrays (per-layer arrays stacked on a leading ``[L]`` axis) and
  builds a ``TransformerLM`` that computes what the reference computes
  with those weights; the tests and ``chip_smoke.py`` feed both packages
  the same arrays this way.
* ``numpy_params`` makes such a pytree from a numpy seed, for runs that
  have no JAX (the card tests and ``chip_smoke.py``).
* ``init_lm`` makes random weights at full width directly on the card,
  one tensor at a time in the target dtype: a full-width f32 copy of
  Gemma-2-27B would be 109 GB.
"""
from __future__ import annotations

import numpy as np
import torch

from .layers import dense_init, embed_init
from .transformer import LMConfig, TransformerLM, layer_shapes


def lm_from_numpy(cfg: LMConfig, params: dict, device="cuda",
                  dtype=torch.float32) -> TransformerLM:
    """The reference's parameter pytree (numpy) -> ``TransformerLM``."""
    def t(a):
        return torch.as_tensor(np.array(a)).to(device=device, dtype=dtype)
    lay = params["layers"]
    layers = [{name: t(lay[name][i]) for name in layer_shapes(cfg)}
              for i in range(cfg.n_layers)]
    unembed = params.get("unembed")
    return TransformerLM(cfg, t(params["embed"]), t(params["final_norm"]),
                         layers, None if unembed is None else t(unembed))


def numpy_params(cfg: LMConfig, seed: int) -> dict:
    """A reference-layout pytree of f32 numpy arrays from ``seed``.

    Dense weights are ``N(0, 1)`` clipped to +-3 over ``sqrt(fan_in)``,
    the embedding ``N(0, 0.02^2)``, and the norms (zero at the
    reference's init) ``N(0, 0.1^2)``, so a comparison also sees every
    norm weight.
    """
    r = np.random.default_rng(seed)

    def draw(shape):
        if len(shape) == 1:
            return r.normal(0.0, 0.1, shape)
        return np.clip(r.standard_normal(shape), -3, 3) * shape[0] ** -0.5
    L, d = cfg.n_layers, cfg.d_model
    layers = {name: np.stack([draw(shape) for _ in range(L)])
              for name, shape in layer_shapes(cfg).items()}
    params = dict(embed=r.normal(0.0, 0.02, (cfg.vocab, d)),
                  final_norm=draw((d,)), layers=layers)
    if not cfg.tie_embeddings:
        params["unembed"] = draw((d, cfg.vocab))
    f32 = {k: v.astype(np.float32) for k, v in params.items()
           if k != "layers"}
    f32["layers"] = {k: v.astype(np.float32) for k, v in layers.items()}
    return f32


def init_lm(cfg: LMConfig, seed: int, device="cuda",
            dtype=torch.bfloat16) -> TransformerLM:
    """Random weights as the reference's ``init_params`` draws them
    (truncated-normal fan-in dense, ``N(0, 0.02^2)`` embedding, zero
    norms), from a ``torch.Generator`` on ``device``, each tensor drawn
    in f32 and cast to ``dtype`` before the next is made."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kw = dict(dtype=dtype, device=device)
    d = cfg.d_model
    embed = embed_init((cfg.vocab, d), gen, **kw)
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({name: (torch.zeros(shape, **kw) if len(shape) == 1
                              else dense_init(shape, gen, **kw))
                       for name, shape in layer_shapes(cfg).items()})
    unembed = (None if cfg.tie_embeddings
               else dense_init((d, cfg.vocab), gen, **kw))
    return TransformerLM(cfg, embed, torch.zeros((d,), **kw), layers,
                         unembed)

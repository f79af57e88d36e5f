"""The port's optimizer and train step against ``repro.train`` on the same
numpy inputs.

Tolerances: ``cosine_lr``, ``global_norm``, ``clip_by_global_norm``,
``adamw_update`` and ``sgd_update`` on given gradients 1e-6 relative
(f32; both evaluate the same expressions, XLA and torch may fuse a
multiply-add differently); ``rng.uniform`` and ``compress_decompress``
bit-equal under the same key, with jax's x64 mode and threefry mode
pinned (importing ``repro.core`` turns x64 on for the whole process, and
under x64 ``jax.random.uniform`` draws 64-bit floats); a train step with
gradient accumulation or compression 1e-5.  The reference's own cases
(``tests/test_train.py:24-90``) run on the port as well.
"""
from __future__ import annotations

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jo
from repro.train import steps as js
from repro_torch.core import rng
from repro_torch.train import pytree
from repro_torch.train.optimizer import (AdamState, AdamWConfig, adamw_init,
                                         adamw_update, clip_by_global_norm,
                                         cosine_lr, global_norm, sgd_update)
from repro_torch.train.steps import (compress_decompress, make_eval_step,
                                     make_train_step, value_and_grad)

RTOL = 1e-6


def _np_tree(seed, shapes):
    r = np.random.default_rng(seed)
    return {k: r.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def _torch(tree):
    return pytree.tree_map(lambda a: torch.tensor(np.array(a)), tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


SHAPES = dict(w=(6, 3), b=(3,), emb=(10, 4))


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (5, 5)])
def test_cosine_lr_matches_reference(warmup, total):
    jcfg = jo.AdamWConfig(lr=0.3, warmup_steps=warmup, total_steps=total)
    cfg = AdamWConfig(lr=0.3, warmup_steps=warmup, total_steps=total)
    for s in range(0, total + 12):
        want = float(jo.cosine_lr(jcfg, jnp.asarray(s, jnp.int32)))
        got = float(cosine_lr(cfg, torch.tensor(s, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=RTOL, abs=1e-9), s


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match_reference(max_norm):
    g = _np_tree(0, SHAPES)
    want, wn = jo.clip_by_global_norm(_jax(g), max_norm)
    got, gn = clip_by_global_norm(_torch(g), max_norm)
    _close(float(gn), float(wn))
    _close(float(global_norm(_torch(g))), float(jo.global_norm(_jax(g))))
    for k in SHAPES:
        _close(got[k].numpy(), want[k])


def test_adamw_update_matches_reference_on_given_grads():
    """Five updates on given gradients, the moments and metrics too; an
    integer leaf is carried through untouched with a ``zeros(())``
    moment, as the reference does."""
    cfg_kw = dict(lr=0.01, warmup_steps=2, total_steps=8, weight_decay=0.1)
    params = _np_tree(1, SHAPES)
    params["count"] = np.arange(4, dtype=np.int32)
    jp, tp = _jax(params), _torch(params)
    js_, ts_ = jo.adamw_init(jp), adamw_init(tp)
    assert ts_.mu["count"].shape == () and ts_.mu["w"].dtype == torch.float32
    for step in range(5):
        g = _np_tree(10 + step, SHAPES)
        g["count"] = np.zeros(4, np.int32)
        jp, js_, jm = jo.adamw_update(jo.AdamWConfig(**cfg_kw), _jax(g),
                                      js_, jp)
        tp, ts_, tm = adamw_update(AdamWConfig(**cfg_kw), _torch(g), ts_, tp)
        for k in SHAPES:
            _close(tp[k].numpy(), jp[k])
            _close(ts_.mu[k].numpy(), js_.mu[k])
            _close(ts_.nu[k].numpy(), js_.nu[k])
        for k in ("grad_norm", "lr"):
            _close(float(tm[k]), float(jm[k]))
        assert int(ts_.step) == int(js_.step) == step + 1
        assert ts_.step.dtype == torch.int32
        assert np.array_equal(tp["count"].numpy(), params["count"])


def test_adamw_update_leaves_its_inputs_intact():
    """Parameters, moments and gradients are only read: the update
    returns new tensors (a step that raises part-way leaves its state
    as it was), bf16 parameters included."""
    params, grads = _torch(_np_tree(2, SHAPES)), _torch(_np_tree(3, SHAPES))
    params["w"] = params["w"].to(torch.bfloat16)
    state = adamw_init(params)
    state = AdamState(step=state.step, mu=_torch(_np_tree(6, SHAPES)),
                      nu=pytree.tree_map(torch.square,
                                         _torch(_np_tree(7, SHAPES))))
    before = pytree.tree_map(torch.clone, (params, grads, state))
    new_p, new_s, _ = adamw_update(AdamWConfig(lr=0.1, warmup_steps=1),
                                   grads, state, params)
    for a, b in zip(pytree.leaves((params, grads, state)),
                    pytree.leaves(before)):
        assert torch.equal(a, b)
    assert new_p["w"].dtype == torch.bfloat16
    for new, old in zip(pytree.leaves((new_p, new_s.mu, new_s.nu)),
                        pytree.leaves((params, state.mu, state.nu))):
        assert new.data_ptr() != old.data_ptr()
        assert not torch.equal(new.float(), old.float())


def test_sgd_update_matches_reference():
    p, g = _np_tree(4, SHAPES), _np_tree(5, SHAPES)
    want = jo.sgd_update(0.1, _jax(g), _jax(p))
    got = sgd_update(0.1, _torch(g), _torch(p))
    for k in SHAPES:
        _close(got[k].numpy(), want[k])


def test_pytree_paths_and_order_match_jax():
    tree = dict(params=dict(layers=[dict(W=1.0, b=2.0), dict(W=3.0)],
                            table=4.0, z=(5.0, [6.0])),
                opt=AdamState(step=7, mu=dict(b=8.0, a=9.0), nu=None))
    jtree = dict(tree, opt=jo.AdamState(step=7, mu=dict(b=8.0, a=9.0),
                                        nu=None))
    flat, _ = jax.tree_util.tree_flatten_with_path(jtree)
    want = [(jax.tree_util.keystr(p), v) for p, v in flat]
    assert pytree.flatten_with_paths(tree) == want
    leaves, tdef = pytree.flatten(tree)
    back = pytree.unflatten(tdef, leaves)
    assert back == tree and isinstance(back["opt"], AdamState)
    assert list(back["params"]) == ["layers", "table", "z"]
    doubled = pytree.tree_map(lambda x: 2 * x, tree)
    assert pytree.leaves(doubled) == [2 * v for _, v in want]


def test_pytree_walks_keep_no_leaf_alive():
    """Flattening, mapping and rebuilding leave no reference cycle that
    holds a leaf: with the cyclic collector off, a dropped tensor dies at
    once (an optimizer step would otherwise keep its gradients until a
    collection)."""
    gc.disable()
    try:
        t = torch.ones(3)
        ref = weakref.ref(t)
        tree = dict(a=[t, (t, None)], b=AdamState(step=t, mu={}, nu=[]))
        pytree.flatten_with_paths(tree)
        leaves, tdef = pytree.flatten(tree)
        pytree.unflatten(tdef, leaves)
        pytree.tree_map(lambda x: x + 1, tree)
        g, _ = clip_by_global_norm(dict(a=t), 1.0)
        del t, tree, leaves, tdef, g
        assert ref() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("x64", [False, True])
@pytest.mark.parametrize("shape", [(1,), (7,), (256, 64), (3, 5, 9)])
def test_uniform_bit_equal(x64, partitionable, shape):
    """``rng.uniform`` draws jax's bits: float32 from 32-bit draws without
    x64, float64 from 64-bit draws under it, in both threefry modes."""
    dtype = torch.float64 if x64 else torch.float32
    with jax.enable_x64(x64), jax.threefry_partitionable(partitionable):
        for seed in (0, 11, 2**31 + 5):
            want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed),
                                                 shape))
            got = rng.uniform(rng.PRNGKey(seed), shape, dtype,
                              partitionable=partitionable).numpy()
            assert got.dtype == want.dtype
            assert np.array_equal(got, want), seed


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("shape", [(256, 64), (33,)])
def test_compress_decompress_bit_equal_under_a_pinned_key(seed, shape):
    g = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(js.compress_decompress(jnp.asarray(g),
                                                 jax.random.PRNGKey(seed)))
    got = compress_decompress(torch.as_tensor(g), rng.PRNGKey(seed))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


def _mse_loss_jax(params, batch):
    return jnp.mean((batch["x"] @ params["w"] + params["b"] - batch["y"]) ** 2)


def _mse_loss(params, batch):
    return torch.mean((batch["x"] @ params["w"] + params["b"]
                       - batch["y"]) ** 2)


def _mse_setup(seed=0):
    r = np.random.default_rng(seed)
    params = dict(w=r.standard_normal((6, 3)).astype(np.float32),
                  b=r.standard_normal(3).astype(np.float32))
    batch = dict(x=r.standard_normal((16, 6)).astype(np.float32),
                 y=r.standard_normal((16, 3)).astype(np.float32))
    return params, batch


@pytest.mark.parametrize("accum,compress", [(1, False), (4, False),
                                            (1, True), (2, True)])
def test_train_step_matches_reference(accum, compress):
    """Three steps of ``make_train_step`` (jitted in the reference):
    losses, metrics and parameters within 1e-5; compression with the
    same key on both sides (x64 pinned off for the reference's draws)."""
    params, batch = _mse_setup()
    cfg_kw = dict(lr=0.05, warmup_steps=1, total_steps=6)
    with jax.enable_x64(False):
        jstep = jax.jit(js.make_train_step(
            _mse_loss_jax, jo.AdamWConfig(**cfg_kw), accum_steps=accum,
            compress_grads=compress))
        jp, jst = _jax(params), jo.adamw_init(_jax(params))
        jm = []
        for s in range(3):
            jp, jst, m = jstep(jp, jst, _jax(batch), jax.random.PRNGKey(s))
            jm.append({k: float(v) for k, v in m.items()})
        jp = jax.tree.map(np.asarray, jp)
    step = make_train_step(_mse_loss, AdamWConfig(**cfg_kw),
                           accum_steps=accum, compress_grads=compress)
    tp = _torch(params)
    tst = adamw_init(tp)
    for s in range(3):
        tp, tst, m = step(tp, tst, _torch(batch), rng.PRNGKey(s))
        for k in ("loss", "grad_norm", "lr"):
            _close(float(m[k]), jm[s][k], rtol=1e-5)
    for k in params:
        _close(tp[k].numpy(), jp[k], rtol=1e-5)


def test_value_and_grad_matches_reference():
    params, batch = _mse_setup(3)
    wl, wg = jax.value_and_grad(_mse_loss_jax)(_jax(params), _jax(batch))
    tp = _torch(params)
    loss, grads = value_and_grad(_mse_loss)(tp, _torch(batch))
    assert not loss.requires_grad and not tp["w"].requires_grad
    _close(float(loss), float(wl))
    for k in params:
        _close(grads[k].numpy(), wg[k], rtol=1e-5)
    unused, g = value_and_grad(lambda p, b: (p["w"] ** 2).sum())(tp, None)
    assert torch.equal(g["b"], torch.zeros(3))
    assert float(make_eval_step(_mse_loss)(tp, _torch(batch))) == \
        pytest.approx(float(wl), rel=1e-6)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_marks_its_parts_in_order(accum):
    """``mark`` is called as each part begins (forward and backward once
    per microbatch) and changes nothing of the step's result."""
    params, batch = _mse_setup(4)
    cfg = AdamWConfig(lr=0.05, warmup_steps=1, total_steps=4)
    seen = []
    marked = make_train_step(_mse_loss, cfg, accum_steps=accum,
                             mark=seen.append)
    plain = make_train_step(_mse_loss, cfg, accum_steps=accum)
    got = marked(_torch(params), adamw_init(_torch(params)), _torch(batch))
    want = plain(_torch(params), adamw_init(_torch(params)), _torch(batch))
    assert seen == ["forward", "backward"] * accum + ["optimizer", "end"]
    for a, b in zip(pytree.leaves(got), pytree.leaves(want)):
        assert torch.equal(a, b)


# --- the reference's own cases (tests/test_train.py:24-90), on the port ---
def _quadratic_loss(params, batch):
    return (torch.sum((params["w"] - batch["target"]) ** 2)
            + torch.sum(params["b"] ** 2))


def test_adamw_converges_on_quadratic():
    params = dict(w=torch.ones((8, 8)), b=torch.ones((8,)))
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=5,
                      total_steps=300)
    step = make_train_step(_quadratic_loss, cfg)
    opt = adamw_init(params)
    batch = dict(target=torch.full((8, 8), 3.0))
    for _ in range(300):
        params, opt, m = step(params, opt, batch)
    assert float(m["loss"]) < 1e-2


def test_cosine_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    lrs = [float(cosine_lr(cfg, torch.tensor(s))) for s in range(101)]
    assert lrs[0] == 0.0
    assert abs(lrs[10] - 1.0) < 1e-6
    assert lrs[100] == pytest.approx(0.1, abs=1e-6)
    assert all(a >= b - 1e-9 for a, b in zip(lrs[10:], lrs[11:]))


def test_grad_accumulation_matches_full_batch():
    params, batch = _mse_setup()
    cfg = AdamWConfig(lr=0.01, weight_decay=0.0)
    p1, _, m1 = make_train_step(_mse_loss, cfg, accum_steps=1)(
        _torch(params), adamw_init(_torch(params)), _torch(batch))
    p4, _, m4 = make_train_step(_mse_loss, cfg, accum_steps=4)(
        _torch(params), adamw_init(_torch(params)), _torch(batch))
    np.testing.assert_allclose(p1["w"].numpy(), p4["w"].numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)


def test_grad_compression_error_bounded_and_unbiased():
    r = np.random.default_rng(1)
    g = torch.as_tensor(r.normal(size=(256, 64)), dtype=torch.float32)
    outs = [compress_decompress(g, rng.PRNGKey(s)) for s in range(20)]
    err = (outs[0] - g).abs().max() / g.abs().max()
    assert float(err) < 1.2 / 127
    mean = sum(outs) / len(outs)
    bias = float((mean - g).abs().mean() / g.abs().mean())
    assert bias < 0.01


def test_global_norm_clip():
    g = dict(a=torch.full((4,), 10.0), b=torch.full((4,), -10.0))
    clipped, gn = clip_by_global_norm(g, 1.0)
    assert float(gn) == pytest.approx(np.sqrt(800), rel=1e-5)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)

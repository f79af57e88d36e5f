"""The port's EmbeddingBag (the plain version its wrapper runs on CPU
tensors) against the JAX package: the Pallas kernel (with its wrapper's
slot rules) in interpret mode and its jnp oracle, on the kernel tests'
cases (weights, ``-1`` pads); bit-equal for bags of one slot without
weights, the DCN-v2 path; and the wrapper's refusals.

Tolerances are those of ``tests/test_kernels.py``: f32 1e-5, bf16 3e-2
(the Pallas kernel rounds its running sum after every slot, the port
once per bag).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.ops import embedding_bag as pallas_eb
from repro.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.embedding_bag.ops import (IN_FLIGHT, THREADS,
                                                  embedding_bag,
                                                  launch_geometry)
from test_kernels import EB_CASES

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 3e-2)}


def _inputs(case, dtype, seed):
    V, d, B, bag, with_w, pad_frac = case
    r = np.random.default_rng(seed)
    table = r.standard_normal((V, d)).astype(np.float32)
    idx = r.integers(0, V, size=(B, bag))
    idx[r.random((B, bag)) < pad_frac] = -1
    w = r.standard_normal((B, bag)).astype(np.float32) if with_w else None
    tdt, jdt, _ = DTYPES[dtype]
    return ((torch.as_tensor(table).to(tdt), torch.as_tensor(idx),
             None if w is None else torch.as_tensor(w)),
            (jnp.asarray(table, jdt), jnp.asarray(idx, jnp.int32),
             None if w is None else jnp.asarray(w)))


@pytest.mark.parametrize("case", EB_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_matches_pallas_kernel_and_oracle(case, dtype):
    (tt, ti, tw), (jt, ji, jw) = _inputs(case, dtype, EB_CASES.index(case))
    before = embedding_bag.launches
    got = embedding_bag(tt, ti, tw)
    assert embedding_bag.launches == before           # CPU: plain version
    assert got.dtype == tt.dtype and got.shape == (ti.shape[0], tt.shape[1])
    tol = DTYPES[dtype][2]
    for want in (pallas_eb(jt, ji, jw, interpret=True),
                 embedding_bag_ref(jt, ji, jw)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_bags_of_one_are_bit_equal(dtype, idx_dtype):
    """DCN-v2's lookup: one id per bag, no weights, some pads."""
    (tt, ti, _), (jt, ji, _) = _inputs((300, 16, 24, 1, False, 0.2), dtype,
                                       7)
    got = embedding_bag(tt, ti.to(idx_dtype)).float().numpy()
    for want in (pallas_eb(jt, ji, interpret=True),
                 embedding_bag_ref(jt, ji)):
        assert np.array_equal(got, np.asarray(want, np.float32))


def test_out_of_range_ids_read_the_last_row_as_the_reference_gather():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    idx = torch.tensor([[7, -1], [2, 3]])
    got = embedding_bag(table, idx)
    want = embedding_bag_ref(jnp.asarray(table.numpy()),
                             jnp.asarray(idx.numpy()))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got[0].tolist() == [9.0, 10.0, 11.0]


@pytest.mark.parametrize("bad,match", [
    (dict(table=torch.zeros(5, 4, dtype=torch.float16)), "float32 or"),
    (dict(idx=torch.zeros(3, 2)), "int32 or int64"),
    (dict(idx=torch.zeros(6, dtype=torch.int64)), r"\[B, bag\]"),
    (dict(w=torch.zeros(3, 1)), "weights must be"),
    (dict(table=torch.zeros(0, 4)), "empty table"),
    (dict(w=torch.zeros(3, 2, device="meta")), "different devices"),
    (dict(table=torch.zeros(5, 4, device="meta"),
          idx=torch.zeros(3, 2, dtype=torch.int64, device="meta")),
     "no kernel for device"),
])
def test_wrapper_refuses(bad, match):
    args = dict(table=torch.zeros(5, 4),
                idx=torch.zeros(3, 2, dtype=torch.int64), w=None)
    args.update(bad)
    before = embedding_bag.launches
    with pytest.raises(ValueError, match=match):
        embedding_bag(args["table"], args["idx"], args["w"])
    assert embedding_bag.launches == before


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_out_dtype_rules(dtype):
    """``out_dtype``: the table's dtype (the default) or float32.  On a
    bf16 table float32 gives the f32 bag sums unrounded (a sharded
    table's partial bags, added before one rounding); rounded they are
    the default output bit for bit.  Anything else is refused."""
    (tt, ti, tw), (jt, ji, jw) = _inputs((300, 16, 24, 4, True, 0.2),
                                         dtype, 9)
    default = embedding_bag(tt, ti, tw)
    assert default.dtype == tt.dtype
    assert torch.equal(embedding_bag(tt, ti, tw, out_dtype=tt.dtype),
                       default)
    f32 = embedding_bag(tt, ti, tw, out_dtype=torch.float32)
    assert f32.dtype == torch.float32
    assert torch.equal(f32.to(tt.dtype), default)
    want = np.asarray(embedding_bag_ref(jt.astype(jnp.float32), ji, jw))
    np.testing.assert_allclose(f32.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="out_dtype"):
        embedding_bag(tt, ti, tw, out_dtype=torch.float16)


def _visits(g, B, d, bag, per):
    """How often the kernel's loops, under launch ``g``, visit each bag,
    each slot of a bag and each element of a row (a chunk is ``per``
    elements); and the largest element index a chunk reaches."""
    groups = THREADS // g.tpr
    rounds = -(-B // groups)
    batches = -(-rounds // g.bpt)               # of bpt rounds each
    r0 = (np.arange(g.grid)[:, None]            # r0 += grid
          + np.arange(-(-batches // g.grid) + 1)[None, :] * g.grid)
    r0 = r0[r0 < batches]
    r = (r0[:, None] * g.bpt + np.arange(g.bpt)[None, :]).ravel()
    b = (r[:, None] * groups + np.arange(groups)[None, :]).ravel()
    bags = np.bincount(b[b < B], minlength=B)
    spg = IN_FLIGHT // g.bpt
    slots = np.zeros(bag, np.int64)
    for j0 in range(0, bag, spg):
        for s in range(spg):
            if j0 + s < bag:
                slots[j0 + s] += 1
    elems, last = np.zeros(d, np.int64), -1
    for lane in range(g.tpr):
        for c0 in range(lane * per, d, g.tpr * per):
            elems[c0:c0 + per] += 1
            last = max(last, c0 + per - 1)
    return bags, slots, elems, last


@pytest.mark.parametrize("bag", [1, 8, 100])
@pytest.mark.parametrize("B", [1, 2, 3000, 851_968, 6_815_744])
@pytest.mark.parametrize("elem_size", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [8, 13, 16, 128, 520])
def test_launch_geometry_covers_every_bag_and_chunk_once(d, elem_size, B,
                                                         bag):
    """``launch_geometry`` under the kernel's index arithmetic: every bag
    once, every slot of a bag once, every element of a row once, never a
    bag past B nor an element past d; one block a batch, the threads a
    bag a power of two, the bags a thread's slots fit in one stage."""
    vec = d * elem_size % 16 == 0          # the wrapper's rule (aligned)
    g = launch_geometry(B, d, bag, elem_size, vec)
    assert g.tpr in (1, 2, 4, 8, 16, 32) and g.bpt in (1, 2, 4)
    assert g.bpt == 1 or (vec and g.bpt * bag <= IN_FLIGHT)
    rounds = -(-B // (THREADS // g.tpr))
    assert g.grid == -(-rounds // g.bpt)
    per = 16 // elem_size if vec else 1
    bags, slots, elems, last = _visits(g, B, d, bag, per)
    assert (bags == 1).all() and (slots == 1).all() and (elems == 1).all()
    assert last == d - 1
    if vec:                                # one 16-byte chunk a thread
        assert g.tpr * per >= d or g.tpr == 32

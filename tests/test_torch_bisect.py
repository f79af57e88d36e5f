"""The port's segment searches against ``repro.core.bisect`` on random
sorted segments, empty ones included."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.weights  # noqa: F401  (turns on jax x64, as the reference runs)
from repro.core import bisect as rb
from repro_torch.core import bisect as tb


def _segments(seed: int, m: int, nseg: int, Q: int):
    """CSR of ``nseg`` sorted segments (every fifth empty) + queries."""
    r = np.random.default_rng(seed)
    seg_of = np.sort(r.choice([s for s in range(nseg) if s % 5], m))
    ptr = np.searchsorted(seg_of, np.arange(nseg + 1))
    vals = np.concatenate([np.sort(r.integers(0, 1000, ptr[s + 1] - ptr[s]))
                           for s in range(nseg)]).astype(np.int64)
    qs = r.integers(0, nseg, Q)
    lo, hi = ptr[qs].astype(np.int64), ptr[qs + 1].astype(np.int64)
    target = r.integers(-10, 1010, Q).astype(np.int64)
    return vals, lo, hi, target


CASES = [(0, 64, 40, 100), (1, 1000, 30, 500), (2, 5000, 700, 777)]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("upper", [False, True])
def test_seg_bounds_match_reference(case, upper):
    vals, lo, hi, target = _segments(*case)
    assert (lo == hi).any()                      # empty segments present
    it = tb.bisect_iters(len(vals))
    rfn = rb.seg_upper_bound if upper else rb.seg_lower_bound
    tfn = tb.seg_upper_bound if upper else tb.seg_lower_bound
    want = np.asarray(rfn(jnp.asarray(vals), jnp.asarray(lo),
                          jnp.asarray(hi), jnp.asarray(target), iters=it))
    got = tfn(*(torch.as_tensor(a) for a in (vals, lo, hi, target)),
              iters=it).numpy()
    assert np.array_equal(got, want)
    # and it is the true bound inside [lo, hi]
    side = "right" if upper else "left"
    truth = [l + np.searchsorted(vals[l:h], x, side=side)
             for l, h, x in zip(lo, hi, target)]
    assert np.array_equal(got, truth)


@pytest.mark.parametrize("case", CASES)
def test_monotone_find_matches_reference(case):
    """Inverse CDF over a weighted segment with zero-weight slots."""
    r = np.random.default_rng(case[0] + 10)
    m = case[1]
    w = r.integers(0, 4, m) * (r.random(m) < 0.6)
    ps = np.concatenate([[0], np.cumsum(w)]).astype(np.int64)
    Q = case[3]
    lo = r.integers(0, m, Q)
    hi = np.minimum(lo + r.integers(1, 50, Q), m)
    tot = ps[hi] - ps[lo]
    keep = tot > 0
    lo, hi, tot = lo[keep], hi[keep], tot[keep]
    rr = (r.random(len(lo)) * tot).astype(np.int64)
    it = tb.bisect_iters(m)
    jps, jlo = jnp.asarray(ps), jnp.asarray(lo)
    want = np.asarray(rb.monotone_find(lambda p: jps[p] - jps[jlo], jlo,
                                       jnp.asarray(hi), jnp.asarray(rr),
                                       iters=it))
    tps, tlo = torch.as_tensor(ps), torch.as_tensor(lo)
    got = tb.monotone_find(lambda p: tps[p] - tps[tlo], tlo,
                           torch.as_tensor(hi), torch.as_tensor(rr),
                           iters=it).numpy()
    assert np.array_equal(got, want)
    assert (w[got] > 0).all()                    # never a zero-weight slot


@pytest.mark.parametrize("m,want", [(1, 8), (255, 9), (7_833_140, 24)])
def test_trip_count_rule(m, want):
    assert tb.bisect_iters(m) == want == max(8, m.bit_length() + 1)

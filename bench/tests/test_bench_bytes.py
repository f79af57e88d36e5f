"""The frozen byte counts equal a count by hand, sample by sample, on a
2,000-edge graph."""
import bisect

import pytest

from bench import run as harness
from bench.reference import rng
from bench.reference.estimate import Reference
from bench.reference.motifs import OUT
from bench.yardstick.bytes import dep_sum_bytes, sampler_bytes
from bench.tests import small


@pytest.fixture(scope="module")
def ref():
    cfg = small.config("wikitalk", 2000)
    return Reference(*harness.plugin("gen", "chung_lu").generate(
        cfg, 2**31 + 9, "cpu"))


def ceil_log2(x: int) -> int:
    return (max(x, 1) - 1).bit_length()


def hand_sampler_bytes(g, tree, w, edges, window) -> int:
    t = g["t"].tolist()
    src, dst = g["src"].tolist(), g["dst"].tolist()
    words = 0
    for e_row, win in zip(edges.tolist(), window.tolist()):
        words += w.q.bit_length() + 4
        words += 2 + 2 * ceil_log2(int(w.win_hi[win] - w.win_lo[win]))
        for (s, c, meet_end, alpha, beta, use_rev) in tree.schedule():
            e = e_row[s]
            meet = (src if meet_end == 0 else dst)[e]
            a = "out" if alpha == OUT else "in"
            p0, p1 = int(g[f"{a}_ptr"][meet]), int(g[f"{a}_ptr"][meet + 1])
            seg = g[f"{a}_t"][p0:p1].tolist()
            if beta < 0:
                lo, hi = max(t[e] - w.delta, win * w.wd), t[e]
            else:
                lo, hi = t[e], min(t[e] + w.delta, (win + 2) * w.wd - 1)
            n_range = bisect.bisect_right(seg, hi) - bisect.bisect_left(
                seg, lo)
            evals = ceil_log2(n_range) + 1
            words += 5 + 3 * (p1 - p0).bit_length() + 2 + 2 * evals
            pid = int(g["rev_pair_id" if use_rev else "pair_id"][e])
            plist = []
            if pid >= 0:
                q0, q1 = int(g["pair_ptr"][pid]), int(g["pair_ptr"][pid + 1])
                plist = g["pair_t"][q0:q1].tolist()
            n_pair = bisect.bisect_right(plist, hi) - bisect.bisect_left(
                plist, lo)
            words += (3 + 3 * len(plist).bit_length() + 2
                      + evals * (n_pair.bit_length() + 2))
    return words * 8 + 16 + len(window) * 8 * (tree.S + 1)


@pytest.mark.parametrize("motif", ["M4-1", "M4-3", "M5-3", "M6-2"])
def test_sampler_bytes_equal_a_hand_count(ref, motif):
    tree, w = ref.plan(motif, 3600)
    assert w.W > 0
    key = rng.fold_in(rng.PRNGKey(123), 4)
    from bench.reference.sampler import sample
    edges, window = sample(ref.g, ref.k, tree, w, key, 64)
    assert sampler_bytes(ref.g, ref.k, tree, w, edges, window) == (
        hand_sampler_bytes(ref.g, tree, w, edges, window))


@pytest.mark.parametrize("meet_end,alpha", [(0, 1), (1, -1), (0, -1)])
@pytest.mark.parametrize("use_c2", [True, False])
def test_dep_sum_bytes_equal_a_hand_count(ref, meet_end, alpha, use_c2):
    m = ref.g["t"].numel()
    n = int(ref.g["n"])
    P = ref.g["pair_key"].numel()
    want = 8 * m + 4 * m + 8 * (n + 1) + 8 * m      # t, meet, ptr, csr_t
    if use_c2:
        want += 4 * m + 8 * (P + 1) + 8 * m          # pair id, ptr, times
    want += (4 if use_c2 else 2) * 8 * (m + 1) + 8 * m
    assert dep_sum_bytes(ref.g, meet_end, alpha, use_c2) == want

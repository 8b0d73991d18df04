"""Port's torch control-plane functions (CPU tensors) vs the reference's
NumPy host twins and the heapq queue: bit-identical lanes, thresholds,
ring buffers and bucket counts."""
import jax  # noqa: F401  (both packages in one process, as the tests run)
import numpy as np
import pytest
import torch

from repro.core import session as jsession
from repro.core import shed_queue as jsq
from repro.core import threshold as jth
from repro.core.shed_queue import UtilityQueue
from repro_torch.core import session as tsession
from repro_torch.core import shed_queue as tsq
from repro_torch.core import threshold as tth

SUBNORMAL_POOL = [np.float32(0.0), np.float32(1.401298464324817e-45)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(t, a, msg=""):
    np.testing.assert_array_equal(t.numpy(), np.asarray(a), err_msg=msg)


def _ref_multiset(q: UtilityQueue):
    return sorted((e.utility, e.seq) for e in q._min if not e.dropped)


def _lane_multiset(util, seq, c):
    u, s = np.asarray(util)[c], np.asarray(seq)[c]
    return sorted((float(a), int(b)) for a, b in zip(u[s >= 0], s[s >= 0]))


def _run_mixed_ops(rng, C=3, K=6, T=5, rounds=6, utilities=None):
    """tests/test_serve_step.py:37 with torch lanes: heapq references,
    the reference's host lanes and the port's torch lanes go through the
    same mixed op sequence; multiset parity vs heapq and bitwise parity
    torch-vs-host after every op."""
    cap = rng.integers(1, K + 1, C).astype(np.int32)
    refs = [UtilityQueue(int(cap[c])) for c in range(C)]
    hu, hs, hn = jsq.make_lanes(C, K)
    du, ds, dn = tsq.make_lanes(C, K, device="cpu")
    pool = utilities or [0.1, 0.2, 0.5, 0.5, 0.5, 0.9]

    for _ in range(rounds):
        kind = int(rng.integers(0, 4))
        if kind == 0:       # batch push
            u = rng.choice(pool, (C, T)).astype(np.float32)
            admit = rng.random((C, T)) < 0.8
            for c in range(C):
                for t in range(T):
                    if admit[c, t]:
                        refs[c].push(("f", c, t), float(u[c, t]))
            du, ds, dn, dp, des, deb = tsq.push_batch_dev(
                du, ds, dn, _t(u), _t(admit), _t(cap))
            hn, hp, hes, heb = jsq.push_batch_host(hu, hs, hn, u, admit, cap)
            _eq(dp, hp)
            _eq(des, hes)
            _eq(deb, heb)
        elif kind == 1:     # single push
            u = rng.choice(pool, C).astype(np.float32)
            do = rng.random(C) < 0.7
            ref_evicted = {}
            for c in range(C):
                if do[c]:
                    ref_evicted[c] = refs[c].push(("s", c), float(u[c]))
            du, ds, dn, dp, des, die = tsq.push_one_dev(
                du, ds, dn, _t(u), _t(do), _t(cap))
            hn, hp, hes, hie = jsq.push_one_host(hu, hs, hn, u, do, cap)
            _eq(dp, hp)
            _eq(des, hes)
            _eq(die, hie)
            for c in range(C):      # eviction iff the reference evicted
                assert (hes[c] >= 0) == (ref_evicted.get(c) is not None)
        elif kind == 2:     # resize
            cap = rng.integers(1, K + 1, C).astype(np.int32)
            for c in range(C):
                refs[c].resize(int(cap[c]))
            du, ds, des = tsq.resize_dev(du, ds, _t(cap))
            hes = jsq.resize_host(hu, hs, cap)
            _eq(des, hes)
        else:               # pop best across the array
            bc, bu = -1, -np.inf
            for c, q in enumerate(refs):
                pu = q.peek_best_utility()
                if pu is not None and pu > bu:
                    bc, bu = c, pu
            ref_item = refs[bc].pop_best() if bc >= 0 else None
            du, ds, dcam, dseq = tsq.pop_best_dev(du, ds)
            hcam, hseq = jsq.pop_best_host(hu, hs)
            assert (int(dcam), int(dseq)) == (hcam, hseq)
            assert (ref_item is None) == (hseq < 0)
            if ref_item is not None:
                assert ref_item[1] == hcam
        _eq(du, hu)
        _eq(ds, hs)
        _eq(dn, hn)
        for c in range(C):
            assert _lane_multiset(hu, hs, c) == _ref_multiset(refs[c]), c


@pytest.mark.parametrize("start", [0, 10, 20])
def test_queue_lanes_match_heapq_and_host(start):
    for trial in range(start, start + 10):
        _run_mixed_ops(np.random.default_rng(trial))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 3276])
def test_queue_lanes_subnormal_pool(seed):
    """The pool the reference's property test recorded
    (``[0.0, 1.4e-45]``): torch keeps the float32 subnormal apart from
    0.0 (its comparisons and the int64 sort keys see every bit), so the
    lanes stay in lockstep with the host twin and heapq."""
    _run_mixed_ops(np.random.default_rng(seed), utilities=SUBNORMAL_POOL)
    _run_mixed_ops(np.random.default_rng(seed + 100), rounds=12,
                   utilities=SUBNORMAL_POOL + [np.float32(0.5)])


def _fuzz_lanes(rng, C, K, fill=0.7):
    util = np.full((C, K), -np.inf, np.float32)
    seq = np.full((C, K), -1, np.int32)
    nxt = 0
    for c in range(C):
        for s in range(K):
            if rng.random() < fill:
                util[c, s] = np.float32(rng.integers(0, 8) / 8.0)
                seq[c, s] = nxt
                nxt += 1
    return util, seq


def test_pop_topk_matches_host(rng):
    for _ in range(25):
        C, K = int(rng.integers(1, 6)), int(rng.integers(1, 8))
        util, seq = _fuzz_lanes(rng, C, K, fill=float(rng.uniform(0, 1)))
        rows = rng.random(C) < 0.7 if rng.random() < 0.3 else None
        k = int(rng.integers(1, C * K + 3))
        hu, hs = util.copy(), seq.copy()
        hc, hseq = jsq.pop_topk_host(hu, hs, k, rows=rows)
        du, ds, dc, dseq = tsq.pop_topk_dev(
            _t(util), _t(seq), k, None if rows is None else _t(rows))
        _eq(dc, hc)
        _eq(dseq, hseq)
        _eq(ds, hs)
        _eq(du, hu)


def test_pop_topk_signed_zero_tiebreak():
    """-0.0 and +0.0 are the same rank (IEEE ==): FIFO by (cam, seq),
    exactly like sequential pop_best (the ``u + 0.0`` canonicalisation)."""
    util = np.array([[np.float32(-0.0), np.float32(0.0)],
                     [np.float32(0.0), np.float32(-0.0)]], np.float32)
    seq = np.array([[5, 1], [2, 0]], np.int32)
    hc, hs = jsq.pop_topk_host(util.copy(), seq.copy(), 4)
    _, _, dc, ds = tsq.pop_topk_dev(_t(util), _t(seq), 4)
    _eq(dc, hc)
    _eq(ds, hs)
    assert list(hc) == [0, 0, 1, 1] and list(hs) == [1, 5, 0, 2]


def test_threshold_lanes_and_counts_edge_cases(rng):
    """Empty, single-entry, partial and full windows at every rate:
    the torch sort path and the O(bins) counts path are bit-identical to
    the host twins."""
    lens = (0, 1, 17, 64, 40)
    C, W, B = len(lens), 64, 32
    buf = np.zeros((C, W), np.float32)
    n = np.asarray(lens, np.int32)
    for c in range(C):
        buf[c, :n[c]] = rng.choice([0.0, 0.25, 0.5, 0.5, 0.77, 1.0],
                                   n[c]).astype(np.float32)
    counts = jth.counts_from_ring_host(buf, n, 0.0, float(B), B)
    for r in (0.0, 1e-3, 0.33, 0.5, 0.999, 1.0, 1.2):
        rates = np.full((C,), r, np.float32)
        _eq(tth.thresholds_from_lanes_dev(_t(buf), _t(n), _t(rates)),
            jth.thresholds_from_lanes_host(buf, n, rates), f"lanes r={r}")
        _eq(tth.thresholds_from_counts_dev(_t(counts), _t(n), _t(rates),
                                           0.0, 1.0 / B),
            jth.thresholds_from_counts_host(counts, n, rates, 0.0, 1.0 / B),
            f"counts r={r}")


def test_threshold_subnormal_window():
    """A window of 0.0 and the smallest subnormal: nextafter and the
    bucket map agree with the host twins bit for bit."""
    buf = np.array([SUBNORMAL_POOL * 4, [SUBNORMAL_POOL[1]] * 8], np.float32)
    n = np.array([8, 5], np.int32)
    for r in (0.1, 0.5, 0.9):
        rates = np.full((2,), r, np.float32)
        _eq(tth.thresholds_from_lanes_dev(_t(buf), _t(n), _t(rates)),
            jth.thresholds_from_lanes_host(buf, n, rates))
    _eq(tth.bucket_index_dev(_t(buf), 0.0, 256.0, 256),
        jth.bucket_index_host(buf, 0.0, 256.0, 256))


@pytest.mark.parametrize("W,bins", [(8, 16), (32, 256)])
def test_ring_push_wraps_like_host(W, bins, rng):
    """Ring pushes through empty, partial, full and wrapped states (and a
    batch longer than the window): buf/pos/len/counts bit-identical to
    the reference host twin, counts == a recount, thresholds equal."""
    C = 3
    hb = np.zeros((C, W), np.float32)
    hp, hl = np.zeros(C, np.int32), np.zeros(C, np.int32)
    hc = np.zeros((C, bins), np.int32)
    tb, tp, tl, tc = _t(hb), _t(hp), _t(hl), _t(hc)
    lo, inv = 0.0, float(bins)
    for T in (1, 3, W - 1, 2, W + 5, 4):
        us = rng.uniform(0, 1, (C, T)).astype(np.float32)
        hp, hl = jsession._ring_push_host(hb, hp, hl, hc, us, None, lo, inv)
        tb, tp, tl, tc = tsession._ring_push(tb, tp, tl, tc, _t(us), lo, inv)
        for a, b in ((tb, hb), (tp, hp), (tl, hl), (tc, hc)):
            _eq(a, b, f"T={T}")
        _eq(tc, jth.counts_from_ring_host(hb, hl, lo, inv, bins))
        rates = rng.uniform(0, 1, C).astype(np.float32)
        _eq(tth.thresholds_from_lanes_dev(tb, tl, _t(rates)),
            jth.thresholds_from_lanes_host(hb, hl, rates))
    assert int(hl[0]) == W and int(hp[0]) != 0      # wrapped mid-buffer

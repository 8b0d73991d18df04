"""Utility-ordered bounded queues with dynamic sizing (paper §IV-D).

Second layer of admission control: when a queue is full, the
lowest-utility frame is evicted (whether resident or incoming); the
transmission layer always sends the current *best* frame. Queues never
shrink below size 1 ("avoid starving the downstream operators").

Two implementations of the same contract:

``UtilityQueue``
    The scalar heapq queue — one Python object per camera. Kept as the
    executable *reference semantics* (the array lanes are tested
    against it) and as the single-camera ``LoadShedder``'s queue.

Array lanes (``*_dev`` / ``*_host`` functions)
    The serve-path form: C cameras' queues as fixed-capacity ``(C, K)``
    ``util``/``seq`` lanes (empty slots ``util=-inf``, ``seq=-1``) plus
    a ``(C,)`` ``next_seq`` push counter. Each operation exists twice
    with bit-identical float32 results: ``*_dev`` (torch, on the
    session's device) and ``*_host`` (vectorized NumPy; mutates the
    lane arrays in place).

    Ordering contract (must match the heapq reference exactly):
      * eviction removes the minimum by ``(utility, seq)`` — lowest
        utility first, FIFO (oldest ``seq``) among ties;
      * ``pop_best`` removes the maximum utility, oldest ``seq`` among
        ties; the any-camera variant prefers the lowest camera index
        among utility ties.
      * a batch of pushes into a bounded queue leaves exactly the
        top-``cap`` of residents ∪ admitted by ``(utility, seq)`` —
        order-free top-k selection is equivalent to sequential
        push/evict because eviction always removes the current minimum
        of a totally ordered set.

    torch has neither a multi-key sort nor a ``uint64`` sort, so the
    device twins sort int64 keys that order exactly like the host's
    ``uint64`` keys (float32 bits mapped to keep their order, ``seq`` in
    the low word), with ``stable=True``; comparisons never go through
    float arithmetic, so subnormal utilities keep their order.

    Utilities are assumed finite (the model's scores are); ``-inf`` is
    reserved for empty slots and ``+inf`` for sort sentinels.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

INT32_MAX = np.int32(2**31 - 1)
_U32 = 0xFFFFFFFF
_SIGN = 0x80000000


@dataclass(order=True)
class _Entry:
    utility: float
    seq: int                      # FIFO tiebreak: prefer older on eviction? paper
    item: Any = field(compare=False)
    dropped: bool = field(default=False, compare=False)


class UtilityQueue:
    """Min-heap on utility so eviction of the worst frame is O(log n);
    pop_best scans lazily via a parallel max-heap."""

    def __init__(self, max_size: int = 8):
        self._max = max(1, int(max_size))
        self._min: List[_Entry] = []
        self._max_heap: List[Tuple[float, int, _Entry]] = []
        self._counter = itertools.count()
        self.evictions = 0

    def __len__(self):
        return sum(1 for e in self._min if not e.dropped)

    @property
    def max_size(self) -> int:
        return self._max

    def resize(self, new_size: int) -> List[Any]:
        """Dynamic queue sizing: shrink drops the lowest-utility frames."""
        self._max = max(1, int(new_size))
        dropped = []
        while len(self) > self._max:
            dropped.append(self._evict_worst())
        return dropped

    def push(self, item: Any, utility: float) -> Optional[Any]:
        """Insert; returns the evicted item (possibly ``item`` itself) or None."""
        e = _Entry(float(utility), next(self._counter), item)
        heapq.heappush(self._min, e)
        heapq.heappush(self._max_heap, (-e.utility, e.seq, e))
        if len(self) > self._max:
            self.evictions += 1
            return self._evict_worst()
        return None

    def _evict_worst(self) -> Any:
        while self._min:
            e = heapq.heappop(self._min)
            if not e.dropped:
                e.dropped = True
                return e.item
        raise RuntimeError("evict from empty queue")

    def pop_best(self) -> Optional[Any]:
        while self._max_heap:
            _, _, e = heapq.heappop(self._max_heap)
            if not e.dropped:
                e.dropped = True
                return e.item
        return None

    def peek_best_utility(self) -> Optional[float]:
        while self._max_heap and self._max_heap[0][2].dropped:
            heapq.heappop(self._max_heap)
        return -self._max_heap[0][0] if self._max_heap else None

    def min_utility(self) -> Optional[float]:
        while self._min and self._min[0].dropped:
            heapq.heappop(self._min)
        return self._min[0].utility if self._min else None


# ---------------------------------------------------------------------------
# Array-backed queue lanes — shared helpers
# ---------------------------------------------------------------------------

def make_lanes(num_cameras: int, capacity: int, device: DeviceLike = None):
    """Fresh empty (C, K) torch lanes on ``device``: (util, seq, next_seq)."""
    dev = resolve_device(device)
    return (torch.full((num_cameras, capacity), float("-inf"),
                       dtype=torch.float32, device=dev),
            torch.full((num_cameras, capacity), -1, dtype=torch.int32,
                       device=dev),
            torch.zeros((num_cameras,), dtype=torch.int32, device=dev))


def make_lanes_host(num_cameras: int, capacity: int):
    """Fresh empty (C, K) NumPy lanes: (util, seq, next_seq)."""
    return (np.full((num_cameras, capacity), -np.inf, np.float32),
            np.full((num_cameras, capacity), -1, np.int32),
            np.zeros((num_cameras,), np.int32))


def _order_key_host(util: np.ndarray, seq: np.ndarray) -> np.ndarray:
    """Ascending uint64 key realizing the (utility, seq) lexicographic
    order — the float32 bits are mapped order-preservingly into the
    high word, the (signed) seq into the low word."""
    ub = np.ascontiguousarray(util, np.float32).view(np.uint32)
    fkey = np.where(ub >> 31 == 1, ~ub, ub | np.uint32(0x80000000))
    skey = np.asarray(seq, np.int32).view(np.uint32) ^ np.uint32(0x80000000)
    return (fkey.astype(np.uint64) << np.uint64(32)) | skey.astype(np.uint64)


def _float_key_dev(util):
    """int64 in [0, 2**32), ascending in the float32 total order — the
    bit map of :func:`_order_key_host`'s high word."""
    ub = util.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & _U32
    return torch.where(ub >= _SIGN, ub ^ _U32, ub | _SIGN)


def _order_key_dev(util, seq):
    """int64 key ordering exactly like :func:`_order_key_host`'s uint64
    key (shifted down by 2**63 so that it fits a signed word)."""
    skey = (seq.to(torch.int64) & _U32) ^ _SIGN
    return (_float_key_dev(util) - _SIGN) * (1 << 32) + skey


# ---------------------------------------------------------------------------
# Top-cap selection (the batch push / resize core)
# ---------------------------------------------------------------------------
#
# Sorting candidates ascending by (util, seq) puts empty slots
# ((-inf, -1)) first, then valid entries worst-to-best. With per-row
# counts (n_inval invalid, n_evict to drop), the evicted entries occupy
# sorted positions [n_inval, n_inval + n_evict) and the survivors are
# the final n_keep positions; gathering the last K positions re-packs
# the lanes (sorted ascending — a canonical layout both impls share).

def _select_core(u_sorted, s_sorted, b_sorted, total, keep_cap, K, xp):
    C, M = u_sorted.shape
    n_keep = xp.minimum(total, keep_cap)
    n_evict = total - n_keep
    n_inval = M - total
    pos = xp.arange(M, dtype=xp.int32)
    evict = ((pos[None, :] >= n_inval[:, None])
             & (pos[None, :] < (n_inval + n_evict)[:, None]))
    evicted_seq = xp.where(evict, s_sorted, -1).astype(xp.int32)
    evicted_bidx = xp.where(evict, b_sorted, -1).astype(xp.int32)
    alive = pos[None, M - K:] >= (M - n_keep)[:, None]
    new_util = xp.where(alive, u_sorted[:, M - K:],
                        xp.float32(-xp.inf)).astype(xp.float32)
    new_seq = xp.where(alive, s_sorted[:, M - K:], -1).astype(xp.int32)
    return new_util, new_seq, evicted_seq, evicted_bidx


def _select_core_dev(u_sorted, s_sorted, b_sorted, total, keep_cap, K):
    """Torch form of :func:`_select_core` (same arithmetic)."""
    C, M = u_sorted.shape
    n_keep = torch.minimum(total, keep_cap.to(torch.int32))
    n_evict = total - n_keep
    n_inval = M - total
    pos = torch.arange(M, dtype=torch.int32, device=u_sorted.device)
    evict = ((pos[None, :] >= n_inval[:, None])
             & (pos[None, :] < (n_inval + n_evict)[:, None]))
    evicted_seq = torch.where(evict, s_sorted, -1).to(torch.int32)
    evicted_bidx = torch.where(evict, b_sorted, -1).to(torch.int32)
    alive = pos[None, M - K:] >= (M - n_keep)[:, None]
    new_util = torch.where(alive, u_sorted[:, M - K:],
                           float("-inf")).to(torch.float32)
    new_seq = torch.where(alive, s_sorted[:, M - K:], -1).to(torch.int32)
    return new_util, new_seq, evicted_seq, evicted_bidx


def select_dev(util, seq, bidx, keep_cap, K):
    """Device top-cap selection (see module docstring for the contract):
    one stable sort of the int64 ``(utility, seq)`` keys."""
    order = torch.sort(_order_key_dev(util, seq), dim=-1,
                       stable=True).indices
    u_s = torch.gather(util.to(torch.float32), -1, order)
    s_s = torch.gather(seq.to(torch.int32), -1, order)
    b_s = torch.gather(bidx.to(torch.int32), -1, order)
    total = (seq >= 0).sum(dim=-1).to(torch.int32)
    return _select_core_dev(u_s, s_s, b_s, total, keep_cap, K)


def select_host(util, seq, bidx, keep_cap, K):
    """NumPy twin of :func:`select_dev` (bit-identical results)."""
    order = np.argsort(_order_key_host(util, seq), axis=-1, kind="stable")
    u_s = np.take_along_axis(np.asarray(util, np.float32), order, -1)
    s_s = np.take_along_axis(np.asarray(seq, np.int32), order, -1)
    b_s = np.take_along_axis(np.asarray(bidx, np.int32), order, -1)
    total = (seq >= 0).sum(axis=-1).astype(np.int32)
    return _select_core(u_s, s_s, b_s, total, keep_cap, K, np)


# ---------------------------------------------------------------------------
# Batch push (vectorized admission)
# ---------------------------------------------------------------------------

def _push_batch_args(util, seq, next_seq, u, admit, cap, xp):
    C, K = util.shape
    T = u.shape[1]
    npush = xp.cumsum(admit.astype(xp.int32), axis=1)
    seq_in = next_seq[:, None] + npush - 1
    cand_u = xp.concatenate(
        [util, xp.where(admit, u, xp.float32(-xp.inf))], axis=1)
    cand_s = xp.concatenate([seq, xp.where(admit, seq_in, -1)],
                            axis=1).astype(xp.int32)
    tcols = xp.broadcast_to(xp.arange(T, dtype=xp.int32)[None, :], (C, T))
    cand_b = xp.concatenate(
        [xp.full((C, K), -1, xp.int32), xp.where(admit, tcols, -1)], axis=1)
    cap_eff = xp.clip(cap, 1, K).astype(xp.int32)
    pushed_seq = xp.where(admit, seq_in, -1).astype(xp.int32)
    new_next = (next_seq + npush[:, -1]).astype(xp.int32)
    return cand_u, cand_s, cand_b, cap_eff, pushed_seq, new_next


def push_batch_dev(util, seq, next_seq, u, admit, cap):
    """Push a (C, T) utility batch (``admit`` masks real pushes) into
    the lanes; equivalent to T sequential heapq pushes per camera.

    Returns (util', seq', next_seq', pushed_seq (C, T),
    evicted_seq (C, K+T), evicted_bidx (C, K+T)): ``pushed_seq`` maps
    batch slots to assigned seqs (-1 not pushed); ``evicted_bidx``
    marks evictions of *this batch's* frames by batch column (-1 for
    evicted pre-batch residents, whose seqs are in ``evicted_seq``).
    """
    C, K = util.shape
    T = u.shape[1]
    dev = util.device
    npush = torch.cumsum(admit.to(torch.int32), dim=1).to(torch.int32)
    seq_in = next_seq[:, None] + npush - 1
    cand_u = torch.cat(
        [util, torch.where(admit, u.to(torch.float32), float("-inf"))], 1)
    cand_s = torch.cat([seq, torch.where(admit, seq_in, -1)],
                       1).to(torch.int32)
    tcols = torch.arange(T, dtype=torch.int32, device=dev)[None, :].expand(
        C, T)
    cand_b = torch.cat([torch.full((C, K), -1, dtype=torch.int32, device=dev),
                        torch.where(admit, tcols, -1)], 1)
    cap_eff = torch.clamp(cap, 1, K).to(torch.int32)
    pushed_seq = torch.where(admit, seq_in, -1).to(torch.int32)
    new_next = (next_seq + npush[:, -1]).to(torch.int32)
    nu, ns, ev_s, ev_b = select_dev(cand_u, cand_s, cand_b, cap_eff, K)
    return nu, ns, new_next, pushed_seq, ev_s, ev_b


def push_batch_host(util, seq, next_seq, u, admit, cap):
    """NumPy twin of :func:`push_batch_dev`; mutates util/seq in place
    and returns (next_seq', pushed_seq, evicted_seq, evicted_bidx)."""
    K = util.shape[1]
    cand_u, cand_s, cand_b, cap_eff, pushed_seq, new_next = _push_batch_args(
        util, seq, next_seq, np.asarray(u, np.float32), admit, cap, np)
    nu, ns, ev_s, ev_b = select_host(cand_u, cand_s, cand_b, cap_eff, K)
    util[...], seq[...] = nu, ns
    return new_next, pushed_seq, ev_s, ev_b


# ---------------------------------------------------------------------------
# Single push (the frame-at-a-time offer path)
# ---------------------------------------------------------------------------
#
# No sort: find the first free slot (queue not full) or replace the
# worst entry (full). Replacement keeps slot layout stable, so the two
# impls stay bitwise identical through mixed push/pop sequences.

def push_one_dev(util, seq, next_seq, u, do_push, cap):
    """Push u[c] for cameras with do_push[c] (others untouched).

    Returns (util', seq', next_seq', pushed_seq (C,),
    evicted_seq (C,), incoming_evicted (C,) bool): ``evicted_seq`` is
    the evicted entry's seq (== pushed_seq when the incoming frame
    itself lost the comparison; -1 when nothing was evicted).
    """
    C, K = util.shape
    rows = torch.arange(C, device=util.device)
    u = u.to(torch.float32)
    valid = seq >= 0
    count = valid.sum(dim=-1)
    cap_eff = torch.clamp(cap, 1, K)
    uv = torch.where(valid, util, float("inf"))
    w_util = uv.amin(dim=-1)
    w_cand = valid & (uv == w_util[:, None])
    w_slot = torch.where(w_cand, seq, int(INT32_MAX)).argmin(dim=-1)
    w_seq = seq[rows, w_slot]
    free_slot = (~valid).to(torch.int32).argmax(dim=-1)
    full = count >= cap_eff
    inc_evicted = do_push & full & (u < w_util)     # tie evicts the resident
    place = do_push & ~inc_evicted
    slot = torch.where(full, w_slot, free_slot)
    new_util = util.clone()
    new_util[rows, slot] = torch.where(place, u, util[rows, slot])
    new_seq = seq.clone()
    new_seq[rows, slot] = torch.where(place, next_seq, seq[rows, slot])
    nn = (next_seq + do_push.to(torch.int32)).to(torch.int32)
    pushed_seq = torch.where(do_push, next_seq, -1).to(torch.int32)
    evicted_seq = torch.where(
        inc_evicted, next_seq,
        torch.where(place & full, w_seq, -1)).to(torch.int32)
    return new_util, new_seq, nn, pushed_seq, evicted_seq, inc_evicted


def push_one_host(util, seq, next_seq, u, do_push, cap):
    """NumPy twin of :func:`push_one_dev`; mutates util/seq in place."""
    C, K = util.shape
    rows = np.arange(C)
    u = np.asarray(u, np.float32)
    valid = seq >= 0
    count = valid.sum(axis=-1)
    cap_eff = np.clip(cap, 1, K)
    uv = np.where(valid, util, np.inf)
    w_util = uv.min(axis=-1)
    w_cand = valid & (uv == w_util[:, None])
    w_slot = np.where(w_cand, seq, INT32_MAX).argmin(axis=-1)
    w_seq = seq[rows, w_slot]
    free_slot = np.argmax(~valid, axis=-1)
    full = count >= cap_eff
    inc_evicted = do_push & full & (u < w_util)
    place = do_push & ~inc_evicted
    slot = np.where(full, w_slot, free_slot)
    util[rows[place], slot[place]] = u[place]
    seq[rows[place], slot[place]] = next_seq[place]
    nn = (next_seq + do_push.astype(np.int32)).astype(np.int32)
    pushed_seq = np.where(do_push, next_seq, -1).astype(np.int32)
    evicted_seq = np.where(
        inc_evicted, next_seq,
        np.where(place & full, w_seq, -1)).astype(np.int32)
    return nn, pushed_seq, evicted_seq, inc_evicted


# ---------------------------------------------------------------------------
# Resize (Eq. 20 dynamic sizing) and transmission (pop/peek best)
# ---------------------------------------------------------------------------

def resize_dev(util, seq, cap):
    """Shrink each row to ``clip(cap, 1, K)`` entries, evicting lowest
    (util, seq) first. Returns (util', seq', evicted_seq (C, K))."""
    K = util.shape[1]
    cap_eff = torch.clamp(cap, 1, K).to(torch.int32)
    nu, ns, ev_s, _ = select_dev(util, seq, torch.full_like(seq, -1),
                                 cap_eff, K)
    return nu, ns, ev_s


def resize_host(util, seq, cap):
    """NumPy twin of :func:`resize_dev`; mutates in place, returns
    the (C, K) padded evicted-seq array."""
    K = util.shape[1]
    cap_eff = np.clip(cap, 1, K).astype(np.int32)
    nu, ns, ev_s, _ = select_host(util, seq, np.full_like(seq, -1),
                                  cap_eff, K)
    util[...], seq[...] = nu, ns
    return ev_s


def _best_slot(util, seq, xp):
    valid = seq >= 0
    bu = xp.where(valid, util, xp.float32(-xp.inf)).max(axis=-1)
    has = valid.any(axis=-1)
    slot = xp.where(valid & (util == bu[:, None]), seq,
                    INT32_MAX).argmin(axis=-1)
    return bu, has, slot.astype(xp.int32)


def _best_slot_dev(util, seq):
    valid = seq >= 0
    bu = torch.where(valid, util, float("-inf")).amax(dim=-1)
    has = valid.any(dim=-1)
    slot = torch.where(valid & (util == bu[:, None]), seq,
                       int(INT32_MAX)).argmin(dim=-1)
    return bu, has, slot


def pop_best_dev(util, seq, cam=None):
    """Pop the best (max utility, oldest seq) entry of camera ``cam``,
    or — cam=None — of the whole array (lowest camera index breaks
    utility ties, matching a sequential strict-``>`` scan).

    Returns (util', seq', cam (int32), popped_seq (int32)) as 0-d
    tensors; negative ``popped_seq`` means every candidate queue was
    empty.
    """
    bu, has, slot = _best_slot_dev(util, seq)
    if cam is None:
        c = torch.argmax(bu)
        ok = has.any()
    else:
        c = torch.as_tensor(int(cam), device=util.device)
        ok = has[c]
    s = slot[c]
    popped_seq = torch.where(ok, seq[c, s], -1).to(torch.int32)
    new_util = util.clone()
    new_util[c, s] = torch.where(ok, float("-inf"), util[c, s])
    new_seq = seq.clone()
    new_seq[c, s] = torch.where(ok, -1, seq[c, s]).to(torch.int32)
    return (new_util, new_seq, torch.where(ok, c, -1).to(torch.int32),
            popped_seq)


def pop_best_host(util, seq, cam=None):
    """NumPy twin of :func:`pop_best_dev`; mutates in place, returns
    (cam, popped_seq) as python ints (-1, -1 when empty)."""
    bu, has, slot = _best_slot(util, seq, np)
    if cam is None:
        if not has.any():
            return -1, -1
        c = int(np.argmax(bu))
    else:
        c = int(cam)
        if not has[c]:
            return -1, -1
    s = int(slot[c])
    popped = int(seq[c, s])
    util[c, s] = -np.inf
    seq[c, s] = -1
    return c, popped


def peek_best_host(util, seq):
    """(best_utility (C,) with -inf for empty, any_nonempty (C,) bool)."""
    bu, has, _ = _best_slot(util, seq, np)
    return bu, has


# ---------------------------------------------------------------------------
# Batched top-k pop (device-side transmission control)
# ---------------------------------------------------------------------------
#
# k sequential pop_best(cam=None) calls emit entries in the strict
# lexicographic order (utility desc, camera asc, seq asc) — a total
# order, since (cam, seq) is unique among live entries. One ordering of
# the flattened (C*K,) lanes therefore reproduces the whole sequence: on
# device two stable sorts (by (cam, seq), then by the utility-desc key)
# ARE the top-k selection; on host an ``np.argpartition`` candidate pool
# + boundary tie fix-up does the same in O(C*K + k log k). Utilities are
# canonicalized with ``u + 0.0`` (folds -0.0 into +0.0, exact for every
# other float) so ±0 ties break by (cam, seq) exactly like the scalar
# pop's ``==`` mask; dev and host use the same order-preserving bit map,
# so they agree bit-for-bit.

def topk_candidates_dev(util, seq, kk: int, rows=None):
    """The first ``kk`` entries of the (C, K) lanes in pop order
    (utility desc, camera asc, seq asc), with no host sync.

    rows: optional (C,) bool mask restricting candidate cameras.
    Returns (flat slot index (kk,) int64, found (kk,) bool, utility-desc
    key (kk,) int64): entries past the live ones have ``found`` False and
    the largest key. The key orders ``±0.0`` as one value and is the same
    on every device, so candidates of several lane blocks merge by
    (key, camera, seq) into the order one block of all of them gives.
    """
    C, K = util.shape
    dev = util.device
    valid = seq >= 0
    if rows is not None:
        valid = valid & rows[:, None]
    valid = valid.reshape(-1)
    seq_f = seq.reshape(-1)
    # utility-desc key (invalid entries last), then (cam, seq) by a
    # preceding stable sort: the three-key (-u, cam, seq) order
    ukey = torch.where(valid, _float_key_dev((util + 0.0).reshape(-1)) ^ _U32,
                       _U32)
    cams = torch.arange(C, dtype=torch.int64, device=dev).repeat_interleave(K)
    o1 = torch.sort(cams * (1 << 32) + ((seq_f.to(torch.int64) & _U32) ^ _SIGN),
                    stable=True).indices
    o2 = torch.sort(ukey[o1], stable=True).indices
    order = o1[o2][:kk]
    return order, valid[order], ukey[order]


def clear_slots_dev(util, seq, idx):
    """New (C, K) lanes with the flat slots ``idx`` emptied; an index of
    ``C*K`` writes to a padding slot that is cut off (no slot). The fill
    values are made on the lanes' device: a Python scalar would be
    copied there from the host, a stream sync."""
    C, K = util.shape
    nu = torch.cat([util.reshape(-1), util.new_zeros(1)])
    nu[idx] = util.new_full((), float("-inf"))
    ns = torch.cat([seq.reshape(-1), seq.new_zeros(1)])
    ns[idx] = seq.new_full((), -1)
    return nu[:C * K].reshape(C, K), ns[:C * K].reshape(C, K)


def pop_topk_dev(util, seq, k: int, rows=None):
    """Pop the ``min(k, C*K)`` best entries of the (C, K) lanes — exactly
    the sequence ``k`` sequential :func:`pop_best_dev` (cam=None) calls
    would pop, with no host sync.

    rows: optional (C,) bool mask restricting candidate cameras.
    Returns (util', seq', cams, seqs): popped identities padded with -1
    past the number of live entries (found entries form a prefix).
    """
    C, K = util.shape
    order, found, _ = topk_candidates_dev(util, seq, min(int(k), C * K),
                                          rows)
    pc = torch.where(found, order // K, -1).to(torch.int32)
    ps = torch.where(found, seq.reshape(-1)[order], -1).to(torch.int32)
    # clear the popped slots; misses write to the padding slot
    nu, ns = clear_slots_dev(util, seq, torch.where(found, order, C * K))
    return nu, ns, pc, ps


def _topk_key_host(util, valid):
    """uint32 key ascending in (utility desc) — the order-preserving
    float32 bit map of :func:`_order_key_host`, complemented. Invalid
    entries map to the maximal key (sorts last, like +inf on device)."""
    u0 = np.asarray(util, np.float32) + np.float32(0.0)   # -0.0 -> +0.0
    ub = np.ascontiguousarray(u0).view(np.uint32)
    fkey = np.where(ub >> 31 == 1, ~ub, ub | np.uint32(0x80000000))
    return np.where(valid, ~fkey, np.uint32(0xFFFFFFFF))


def pop_topk_host(util, seq, k: int, rows=None):
    """NumPy twin of :func:`pop_topk_dev`; mutates the lanes in place,
    returns (cams, seqs) int32 arrays of length ``min(k, C*K)`` padded
    with -1 (popped identities in pop order, live entries first)."""
    C, K = util.shape
    kk = min(int(k), C * K)
    valid = seq >= 0
    if rows is not None:
        valid = valid & np.asarray(rows, bool)[:, None]
    cams_out = np.full((kk,), -1, np.int32)
    seqs_out = np.full((kk,), -1, np.int32)
    m = min(kk, int(valid.sum()))
    if m == 0:
        return cams_out, seqs_out
    dk = _topk_key_host(util, valid).reshape(-1)
    sflat = seq.reshape(-1)
    if m < dk.size:
        part = np.argpartition(dk, m - 1)
        thresh = dk[part[m - 1]]               # the m-th smallest key
        strict = np.flatnonzero(dk < thresh)   # at most m-1 entries
        ties = np.flatnonzero(dk == thresh)
        need = m - strict.size
        if need < ties.size:                   # boundary tie fix-up:
            tc = (ties // K).astype(np.int32)  # oldest (cam, seq) wins
            sel = ties[np.lexsort((sflat[ties], tc))[:need]]
        else:
            sel = ties
        idx = np.concatenate([strict, sel])
    else:
        idx = np.flatnonzero(valid.reshape(-1))
    c_i = (idx // K).astype(np.int32)
    s_i = sflat[idx]
    order = np.lexsort((s_i, c_i, dk[idx]))    # final exact pop order
    c_i, s_i, idx = c_i[order], s_i[order], idx[order]
    sl = (idx % K).astype(np.int32)
    util[c_i, sl] = -np.inf
    seq[c_i, sl] = -1
    cams_out[:m] = c_i
    seqs_out[:m] = s_i
    return cams_out, seqs_out


__all__ = [
    "UtilityQueue", "make_lanes", "make_lanes_host",
    "select_dev", "select_host",
    "push_batch_dev", "push_batch_host",
    "push_one_dev", "push_one_host",
    "resize_dev", "resize_host",
    "pop_best_dev", "pop_best_host", "peek_best_host",
    "pop_topk_dev", "pop_topk_host", "topk_candidates_dev", "clear_slots_dev",
]

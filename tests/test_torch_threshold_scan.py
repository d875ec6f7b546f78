"""The threshold scan's algorithm (wise_tpu_torch/csrc/topk_kernels.cu
``topk_scan_kernel``, behind ``ops.fused_topk.fused_topk_threshold``) as a
numpy model, held against the port's plain version, against the Pallas
threshold kernel of wise_tpu/ops/pallas_topk.py in interpret mode, and on
planted ties against ``wise_tpu.ops.topk.flat_topk``.

The model follows the kernel step by step: the wrapper's row ranges
(``scan_plan``: whole 256-row blocks, not aligned to groups), the
blocks in each range, a lane a row in eight warps of 32, the (score key,
~row) words, the vote against each query's τ, the append behind the kept k,
the flush when a list would pass its capacity (one descending sort, τ the
k-th word), the final sort of each range's list and the merge of the ranges.
The warps of a CTA run concurrently and serialise their appends on the
query's lock, so the model interleaves their row blocks in a seeded random
order. The capacity is a parameter, so that small lists flush often.

Tolerance: none. Vectors hold small integers (exact in bf16 too), so every
score is exact in f32 whatever the summation order, and scores and rows
must be identical. Against the Pallas kernel the scores are made distinct
(its lane order on ties is not the port's contract).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wise_tpu.ops import pallas_topk as JP
from wise_tpu.ops import topk as J
from wise_tpu_torch.ops import fused_topk as F
from wise_tpu_torch.ops import topk as T

WARPS, LANES = 8, 32
CU = (Path(__file__).resolve().parents[1] / "wise_tpu_torch" / "csrc"
      / "topk_kernels.cu")


def _range_bounds(n_pad, ranges):
    """The kernel's row range of each CTA of a query tile, from its index:
    range i holds blocks [i B / ranges, (i + 1) B / ranges) of the B =
    ceil(n_pad / SCAN_BLOCK_ROWS), the last cut at n_pad."""
    blocks = -(-n_pad // F.SCAN_BLOCK_ROWS)
    return [(min(n_pad, i * blocks // ranges * F.SCAN_BLOCK_ROWS),
             min(n_pad, (i + 1) * blocks // ranges * F.SCAN_BLOCK_ROWS))
            for i in range(ranges)]


def _words(scores, rows):
    """The kernel's 64-bit words: the score's order-preserving key (-0 as
    +0) above ~row, so that the larger word is the better (score
    descending, row ascending); 0 is the empty entry."""
    u = (scores.astype(np.float32) + np.float32(0.0)).view(np.uint32)
    u = u.astype(np.uint64)
    key = np.where(u & 0x80000000, (~u) & 0xFFFFFFFF, u | 0x80000000)
    return (key << np.uint64(32)) | (np.uint64(0xFFFFFFFF)
                                     - rows.astype(np.uint64))


def _unword(words):
    """Words -> (scores, rows), the empty word as (-inf, row 0)."""
    key = (words >> np.uint64(32)).astype(np.uint32)
    bits = np.where(key & 0x80000000, key & 0x7FFFFFFF, ~key)
    scores = bits.astype(np.uint32).view(np.float32)
    rows = (np.uint64(0xFFFFFFFF) - (words & np.uint64(0xFFFFFFFF)))
    empty = words == 0
    return (np.where(empty, -np.inf, scores).astype(np.float32),
            np.where(empty, 0, rows).astype(np.int64))


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float() \
        .numpy()


class _List:
    """One query's list in a CTA: k kept words, then room for ``cap``
    candidates, and τ, the k-th kept word (0 until k are kept)."""

    def __init__(self, k, cap):
        self.k, self.cap = k, cap
        self.words = np.zeros(k + cap, np.uint64)
        self.tau, self.cnt, self.flushes = np.uint64(0), 0, 0

    def append(self, part):
        """A vote's survivors (the words > τ), flushing first when they
        would pass the capacity: one descending sort keeps the first k."""
        surv = part[part > self.tau]
        if self.cnt + len(surv) > self.cap:
            self.first_k()
            self.tau = self.words[self.k - 1]
            self.flushes += 1
            surv = part[part > self.tau]
        at = self.k + self.cnt
        self.words[at:at + len(surv)] = surv
        self.cnt += len(surv)

    def first_k(self):
        self.words[self.k + self.cnt:] = 0
        self.words = np.sort(self.words)[::-1].copy()
        self.cnt = 0
        return self.words[:self.k]


def scan_model(queries, db_pad, n_valid, k, sms=132, cap=None, vote=LANES,
               storage="float32", seed=0):
    """The kernel in numpy: (scores (Q, k'), rows (Q, k'), flushes).
    ``cap``: the candidates a list holds (the kernel's p - k, p from
    ``scan_tile``); ``vote``: the lanes whose survivors are
    appended at once (a warp: 32), at most ``cap``. Flushes of the merge
    are not counted, as the kernel does not count them."""
    n_pad = db_pad.shape[0]
    qn = queries.shape[0]
    k = min(int(k), int(n_valid))
    cap = F.scan_tile(qn, k)[1] - k if cap is None else cap
    assert vote <= cap
    q = queries.astype(np.float32)
    if storage == "bfloat16":
        q = _bf16(q)
    scores = q @ db_pad.astype(np.float32).T  # exact on integer vectors
    ranges = _range_bounds(n_pad, F.scan_plan(n_pad, qn, k, sms)[0])
    rng = np.random.default_rng(seed)
    cands = np.zeros((len(ranges), qn, k), np.uint64)
    flushes = 0
    for slot, (begin, end) in enumerate(ranges):
        # warp w's row blocks, in order; the warps interleave at random
        blocks = list(range(begin // F.SCAN_BLOCK_ROWS,
                            -(-end // F.SCAN_BLOCK_ROWS)))
        steps = np.repeat(np.arange(WARPS), len(blocks))
        rng.shuffle(steps)
        lists = [_List(k, cap) for _ in range(qn)]
        done = np.zeros(WARPS, np.int64)
        for w in steps:
            b = blocks[done[w]]
            done[w] += 1
            rows = b * F.SCAN_BLOCK_ROWS + w * LANES + np.arange(LANES)
            valid = rows < n_valid  # TMA's zeros past n_pad are >= n_valid
            rows_in = np.minimum(rows, n_pad - 1)
            for qi, lst in enumerate(lists):
                words = np.where(valid, _words(scores[qi, rows_in], rows),
                                 np.uint64(0))
                for v0 in range(0, LANES, vote):
                    part = words[v0:v0 + vote]
                    if (part > lst.tau).any():
                        lst.append(part)
        for qi, lst in enumerate(lists):
            cands[slot, qi] = lst.first_k()
            flushes += lst.flushes
    # the merge by the last CTA: τ just under the largest of the ranges'
    # k-th words (each a lower bound of the k-th best), then a lane a range,
    # each group of 32 ranges walked a depth at a time (a range left at its
    # first entry under τ) through one list a query; the groups' order is
    # the warps' (any)
    top = np.zeros((qn, k), np.uint64)
    groups = -(-len(ranges) // vote)
    for qi in range(qn):
        lst = _List(k, cap)
        bound = cands[:, qi, k - 1].max()
        lst.tau = bound - np.uint64(1) if bound else np.uint64(0)
        for g in rng.permutation(groups):
            slots = np.arange(g * vote, min(len(ranges), (g + 1) * vote))
            alive = np.ones(len(slots), bool)
            for j in range(k):
                part = np.where(alive, cands[slots, qi, j], np.uint64(0))
                alive &= part > lst.tau
                if not alive.any():
                    break
                lst.append(np.where(alive, part, np.uint64(0)))
        top[qi] = lst.first_k()
    s, r = _unword(top)
    return s, r, flushes


def _distinct_case(seed, n, d, q, group):
    """Integer vectors with distinct scores for each query: coordinates 0
    and 1 spell a permutation rank, the others weigh 4096 a unit. Query 0
    scores every row negative, so unmasked zero padding would win."""
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 4, (n, d)).astype(np.float32)
    rank = rng.permutation(n)
    db[:, 0], db[:, 1] = rank // 64, rank % 64
    queries = 4096.0 * rng.integers(-2, 3, (q, d)).astype(np.float32)
    queries[:, 0], queries[:, 1] = 64, 1
    queries[0] = -np.abs(queries[0])
    queries[0, :2] = (-64, -1)
    db_pad = np.zeros((-(-n // group) * group, d), np.float32)
    db_pad[:n] = db
    return queries, db_pad


def _tied_case(seed, n, d, q, group):
    """Small integers (ties everywhere, the k-th boundary included) with
    duplicates planted across groups and inside one block."""
    rng = np.random.default_rng(seed)
    db = rng.integers(-2, 3, (n, d)).astype(np.float32)
    db[n // 2] = db[3]
    db[n - 1] = db[3]
    db[7:12] = db[40 % n]
    queries = rng.integers(-2, 3, (q, d)).astype(np.float32)
    queries[0] = -np.abs(queries[0])
    db_pad = np.zeros((-(-n // group) * group, d), np.float32)
    db_pad[:n] = db
    return queries, db_pad


def _plain(queries, db_pad, n_valid, k, group, storage):
    tdb = torch.from_numpy(db_pad).to(getattr(torch, storage))
    s, r = F.fused_topk_threshold_plain(torch.from_numpy(queries), tdb,
                                        n_valid, k, group)
    return s.numpy(), r.numpy()


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))


# ---------------------------------------------------------------------------
# the wrapper's range and list arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_pad", [64, 256, 1000, 4096, 8192, 12288,
                                   1 << 20])
@pytest.mark.parametrize("qn", [1, 8, 16, 17, 32, 128])
@pytest.mark.parametrize("sms", [1, 3, 132])
@pytest.mark.parametrize("k", [10, 1024])
def test_ranges_cover_every_row_once(n_pad, qn, sms, k):
    ranges, qt, _ = F.scan_plan(n_pad, qn, k, sms)
    bounds = _range_bounds(n_pad, ranges)
    blocks = -(-n_pad // F.SCAN_BLOCK_ROWS)
    tiles = -(-qn // qt)
    assert ranges == max(1, min(blocks, sms // tiles))
    assert bounds[0][0] == 0 and bounds[-1][1] == n_pad
    for (b0, e0), (b1, _) in zip(bounds, bounds[1:]):
        assert e0 == b1  # contiguous, so every row is in exactly one
    for b, e in bounds:
        assert b < e  # none empty
        assert b % F.SCAN_BLOCK_ROWS == 0
    # CTAs: at most one an SM, unless the query tiles alone outnumber them
    assert ranges * tiles <= max(sms, tiles)


def test_a_range_ends_inside_a_group():
    """Ranges follow 256-row blocks, not groups: at 8,192 rows in groups of
    4,096 over 3 SMs a range ends inside the first group."""
    bounds = _range_bounds(8192, F.scan_plan(8192, 1, 10, 3)[0])
    assert [e % 4096 for _, e in bounds[:-1]] == [2560, 1280]


@pytest.mark.parametrize("k", [1, 10, 32, 33, 50, 100, 511, 1024])
def test_list_entries(k):
    for qn in (1, 2, 7, 8, 9, 16, 17, 64):
        qt, p = F.scan_tile(qn, k)
        assert p >= 128 and p & (p - 1) == 0  # the bitonic sort's length
        assert p - k >= max(k, 32)  # a warp's survivors fit after a flush
        assert p // 2 < k + max(k, 32) or p == 128  # the least such power
        assert qt in (1, 8, F.SCAN_QUERIES)  # the kernel's instantiations
        # the least tile that holds the batch, unless its lists do not fit
        want = 1 if qn == 1 else 8 if qn <= 8 else F.SCAN_QUERIES
        up = 8 if qt == 1 else F.SCAN_QUERIES  # the next tile up
        assert qt == want or up * p > F.SCAN_LIST_WORDS
        assert qt == 1 or qt * p <= F.SCAN_LIST_WORDS


def _cu_int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         CU.read_text()).group(1))


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 50, 100, 128, 300, 1024])
@pytest.mark.parametrize("d", [8, 512, 1000, 1024, 1280])
def test_plan_leaves_the_ring_three_stages(storage, k, d):
    """The C entry refuses a plan whose shared memory leaves the ring fewer
    than kScanMinStages stages: scan_smem of csrc/topk_kernels.cu, its
    constants read from the source, at every tile scan_tile picks."""
    assert _cu_int("kScanMaxQT") == F.SCAN_QUERIES
    smem_max, warps = _cu_int("kScanSmemMax"), _cu_int("kScanWarps")
    stage = warps * 32 * 128 + 16  # a stage of 256 rows x 128 B, 2 barriers
    cols = 64 if storage == "bfloat16" else 32
    dp = -(-d // cols) * cols
    for qn in (1, 8, 16):
        qt, p = F.scan_tile(qn, k)
        mma = storage == "bfloat16" and qt >= 8
        q_bytes = qt * (dp + 8) * 2 if mma else qt * dp * 4
        sb_bytes = warps * 32 * (qt + 1) * 4 if qt >= 8 else 0
        fixed = 1024 + q_bytes + sb_bytes + qt * p * 8 + qt * 16 + 16
        assert (smem_max - fixed) // stage >= _cu_int("kScanMinStages")


def test_the_widest_rows_are_the_registry_s():
    """The wrapper's MAX_D, the C entry's kScanMaxD and the widest joint
    space of the CLIP registry (ViT-bigG-14's 1280) agree, so that every
    index the registry's towers make is searched on the kernels; at that
    width the plan still takes a tile of 16 (three stages of ring, above)."""
    from wise_tpu_torch.models.clip.config import CLIP_CONFIGS

    assert _cu_int("kScanMaxD") == F.MAX_D == 1280
    assert max(c.embed_dim for c in CLIP_CONFIGS.values()) == F.MAX_D
    assert F.scan_plan(1 << 20, 16, 10, 132)[1:] == (16, 128)


# ---------------------------------------------------------------------------
# the model against the plain version and the Pallas kernel
# ---------------------------------------------------------------------------

#: (n, d, q, k, group, sms): one query, a tile of 8 and of 16, an n_valid
#: off a block boundary, ranges ending inside groups, k = 1; the widest
#: rows (ViT-bigG-14's 1280-d joint space) at a tile of 16 and of 1
PALLAS_CASES = [(1000, 32, 1, 10, 256, 132), (2048, 16, 8, 100, 256, 3),
                (1500, 24, 16, 7, 512, 5), (700, 8, 3, 1, 128, 2),
                (1000, 1280, 16, 10, 256, 3), (600, 1280, 1, 10, 128, 5)]


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,q,k,group,sms", PALLAS_CASES)
def test_model_matches_plain_and_pallas(n, d, q, k, group, sms, storage):
    queries, db_pad = _distinct_case(n + 7, n, d, q, group)
    want = JP.pallas_topk_threshold(
        jnp.asarray(queries), jnp.asarray(db_pad, getattr(jnp, storage)),
        n_valid=n, k=k, group=group, interpret=True)
    s, r, _ = scan_model(queries, db_pad, n, k, sms=sms, storage=storage)
    _same((s, r), want)
    _same((s, r), _plain(queries, db_pad, n, k, group, storage))
    assert int(r.max()) < n


@pytest.mark.parametrize("qn", [1, 8, 16])
@pytest.mark.parametrize("cap", [32, 40, 64])
def test_ties_at_tau_across_flushes(qn, cap):
    """Small lists flush many times while ties sit at τ: the kept k keep
    the lower rows, as flat_topk does."""
    n, d, k, group = 3000, 8, 20, 512
    queries, db_pad = _tied_case(qn + cap, n, d, qn, group)
    s, r, flushes = scan_model(queries, db_pad, n, k, sms=4, cap=cap)
    assert flushes > 0
    want = J.flat_topk(jnp.asarray(queries), jnp.asarray(db_pad),
                       n_valid=n, k=k, group=group)
    _same((s, r), want)
    _same((s, r), _plain(queries, db_pad, n, k, group, "float32"))


@pytest.mark.parametrize("k", [1, 10, 100])
def test_every_row_tied(k):
    """One vector repeated: every score ties, the answer is the first k
    rows; the first range's list takes them, the others' fill and flush."""
    n, d, group = 2000, 8, 256
    db_pad = np.zeros((2048, d), np.float32)
    db_pad[:n] = 1.0
    queries = np.ones((2, d), np.float32)
    queries[1] = -1.0  # every valid row below the zero padding
    s, r, _ = scan_model(queries, db_pad, n, k, sms=6, cap=32)
    np.testing.assert_array_equal(r, np.tile(np.arange(k), (2, 1)))
    np.testing.assert_array_equal(s[0], np.full(k, d, np.float32))
    np.testing.assert_array_equal(s[1], np.full(k, -d, np.float32))
    _same((s, r), _plain(queries, db_pad, n, k, group, "float32"))


@pytest.mark.parametrize("vote", [1, 8, 32])
def test_flush_that_overflows(vote):
    """Rows whose scores rise with the row: a row block beats τ whenever it
    comes after the blocks that set it, so the lists overflow their
    capacity again and again; the flushes are counted."""
    n, d, k, group = 4096, 8, 16, 1024
    db_pad = np.zeros((n, d), np.float32)
    db_pad[:, 0] = np.arange(n)
    queries = np.zeros((1, d), np.float32)
    queries[0, 0] = 1.0
    s, r, flushes = scan_model(queries, db_pad, n, k, sms=2, cap=32,
                               vote=vote)
    assert flushes >= 2  # at least one a range
    np.testing.assert_array_equal(r[0], np.arange(n - 1, n - 1 - k, -1))
    _same((s, r), _plain(queries, db_pad, n, k, group, "float32"))


def test_fewer_valid_rows_than_k():
    queries, db_pad = _tied_case(5, 6, 8, 2, 64)
    s, r, _ = scan_model(queries, db_pad, 6, 10)
    assert s.shape == r.shape == (2, 6)
    assert sorted(r[0].tolist()) == list(range(6))
    assert bool(np.isfinite(s).all())
    _same((s, r), _plain(queries, db_pad, 6, 10, 64, "float32"))


@pytest.mark.parametrize("n_valid", [255, 257, 1000, 2047])
def test_n_valid_off_a_block_boundary(n_valid):
    """Rows >= n_valid (zero padding that outscores query 0's negative
    rows) never enter, wherever n_valid falls in a block."""
    n, d, k, group = 2048, 16, 30, 256
    queries, db_pad = _tied_case(n_valid, n, d, 3, group)
    db_pad = np.abs(db_pad)
    queries[0] = -(np.abs(queries[0]) + 1)
    s, r, _ = scan_model(queries, db_pad, n_valid, k, sms=3)
    assert int(r.max()) < n_valid
    _same((s, r), _plain(queries, db_pad, n_valid, k, group, "float32"))


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_k_at_max_k(storage):
    """k = MAX_K: a list of 2,048 words, four ranges of 1,280 rows."""
    n, d, group = 5000, 8, 1024
    queries, db_pad = _tied_case(17, n, d, 2, group)
    s, r, _ = scan_model(queries, db_pad, n, F.MAX_K, sms=4,
                         storage=storage)
    assert s.shape == (2, F.MAX_K)
    _same((s, r), _plain(queries, db_pad, n, F.MAX_K, group, storage))


@pytest.mark.parametrize("qn", [1, 8, 16, 17])
def test_order_of_the_warps_does_not_matter(qn):
    """The warps' appends interleave in any order (the kernel runs them
    concurrently): every seed gives flat_topk's answer."""
    n, d, k, group = 2500, 8, 12, 512
    queries, db_pad = _tied_case(qn, n, d, qn, group)
    want = J.flat_topk(jnp.asarray(queries), jnp.asarray(db_pad),
                       n_valid=n, k=k, group=group)
    for seed in range(3):
        s, r, _ = scan_model(queries, db_pad, n, k, sms=2, cap=32,
                             seed=seed)
        _same((s, r), want)


@pytest.mark.parametrize("qn,k,threshold", [
    (1, 10, True), (1, 1024, True), (8, 50, True), (16, 10, True),
    (16, 51, False), (17, 10, False), (32, 10, False), (64, 100, False)])
def test_the_router_cuts_at_16_queries(qn, k, threshold):
    """flat_topk on a card: one query at any k, or up to 16 at k <= 50, to
    the threshold scan (one read of the rows for 16 queries); Q = 32 at k =
    10 already goes to the group path, which the chip rows of both wrappers
    found faster there."""
    assert T.THRESHOLD_MAX_BATCH == F.SCAN_QUERIES == 16
    assert T.routes_to_threshold(qn, k) is threshold


@pytest.mark.parametrize("count,reset,name", [
    (F.overflow_count, F.reset_overflows, "overflows"),
    (F.flush_count, F.reset_flushes, "flushes")])
def test_overflow_counter_resets_in_and_out_of_inference_mode(count, reset,
                                                              name):
    """The counters the group selection's overflows and the scan's flushes
    go to, first made under inference_mode (as a search under it makes
    them), are zeroed outside it too, each apart from the other."""
    dev = torch.device("cpu")
    for n in ("overflows", "flushes"):
        F._counters.pop((n, dev), None)
    try:
        with torch.inference_mode():
            reset(dev)
            F._counter(name, dev).add_(3)
            assert count(dev) == 3
        other = F.flush_count if name == "overflows" else F.overflow_count
        assert other(dev) == 0
        reset(dev)
        assert count(dev) == 0
    finally:
        for n in ("overflows", "flushes"):
            F._counters.pop((n, dev), None)

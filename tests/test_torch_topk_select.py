"""The arithmetic of ``fused_topk``'s group path on the card
(wise_tpu_torch/csrc/topk_kernels.cu), rehearsed on the CPU, where the
kernels cannot run:

- the f32 product's 3xTF32 split (``wt_topk_gemm_f32``): each value x splits
  into hi = tf32(x), rounded to nearest with ties away from zero as
  ``cvt.rna.tf32.f32`` does, and lo = tf32(x - hi); S = hi q_hi + hi q_lo +
  lo q_hi. On integer vectors lo = 0 and the result is the plain product's,
  bit for bit; on seeded unit vectors at D = 512 it stays within 3 x 2^-22
  of sum |x_i q_i| of the float64 product (the dropped lo q_lo and lo's own
  rounding, each <= 2^-22 of a product), far under the top-k rows' 2e-6 bar,
  which one-term (TF32 only) and two-term products break (planted faults);
- the selection (``wt_topk_select``): a numpy model of the kernel's steps
  (order-preserving keys, the lower bound τ from 256 block maxima running
  over the segments, settled bit by bit; the survivors >= τ appended to the
  candidates of the earlier segments, those below τ dropped when the buffer
  is full, past its cap the buffer insertion; one sort at the end),
  with the constants read from the source, against ``select_groups_plain``
  in both branches, with ties at τ, n_valid inside a group, an all-padding
  group, k = group and k beyond the 256 blocks;
- the keyed merge (``_merge``: one ``torch.topk`` over an int64 key) against
  the two stable sorts it replaced, on ties and empty slots.

Tolerance: none, but for the unit-vector bound stated above.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from wise_tpu_torch.ops import fused_topk as F

CU = Path(__file__).resolve().parents[1] / "wise_tpu_torch" / "csrc" / \
    "topk_kernels.cu"


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         CU.read_text()).group(1))


SEG_ROWS, LANE_BLOCKS, TAU_BITS = (_constant("kSegRows"),
                                   _constant("kLaneBlocks"),
                                   _constant("kTauBits"))


# ---------------------------------------------------------------------------
# the 3xTF32 split
# ---------------------------------------------------------------------------


def tf32_rna(x):
    """cvt.rna.tf32.f32 on float32 values: add half of the 13 dropped bits'
    range to the magnitude, then clear them."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def product(db, q, terms=3):
    """Sᵀ-free S = q @ dbᵀ from the TF32 halves in float64 (TF32 products
    are exact there): 1 term hi q_hi, 2 adds hi q_lo, 3 adds lo q_hi."""
    (dh, dl), (qh, ql) = split(db), split(q)
    f = np.float64
    s = qh.astype(f) @ dh.astype(f).T
    if terms >= 2:
        s += ql.astype(f) @ dh.astype(f).T
    if terms >= 3:
        s += qh.astype(f) @ dl.astype(f).T
    return s


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def test_tf32_rounding_is_the_wrappers():
    """The numpy model and the wrapper's torch rounding (ops.fused_topk.tf32,
    which makes q_hi and q_lo) agree bit for bit, ties away from zero
    included, and keep 10 mantissa bits."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(1000).astype(np.float32),
                        np.float32([1 + 2 ** -11, -(1 + 2 ** -11),
                                    1 + 3 * 2 ** -11, 0.0, -0.0, 3.0])])
    got = F.tf32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  tf32_rna(x).view(np.uint32))
    assert (tf32_rna(x).view(np.uint32) & 0x1FFF == 0).all()
    assert tf32_rna(np.float32([1 + 2 ** -11]))[0] == 1 + 2 ** -10
    assert tf32_rna(np.float32([-(1 + 2 ** -11)]))[0] == -(1 + 2 ** -10)
    hi, lo = split(x)
    assert (np.abs(x - hi) <= np.abs(x) * 2.0 ** -11).all()
    # the subtraction that makes lo is exact in f32
    np.testing.assert_array_equal((x.astype(np.float64) - hi),
                                  (x - hi).astype(np.float64))


def test_three_terms_are_exact_on_integer_vectors():
    rng = np.random.default_rng(1)
    db = rng.integers(0, 4, (300, 512)).astype(np.float32)
    q = rng.integers(-2, 3, (8, 512)).astype(np.float32)
    assert not split(db)[1].any() and not split(q)[1].any()
    plain = (torch.from_numpy(q) @ torch.from_numpy(db).T).numpy()
    np.testing.assert_array_equal(product(db, q).astype(np.float32), plain)


def test_three_terms_within_their_bound_and_fewer_terms_break_the_bar():
    rng = np.random.default_rng(2)
    db, q = _unit(rng, 2000, 512), _unit(rng, 16, 512)
    exact = q.astype(np.float64) @ db.astype(np.float64).T
    bound = 3 * 2.0 ** -22 * (np.abs(q).astype(np.float64)
                              @ np.abs(db).astype(np.float64).T)
    err = np.abs(product(db, q) - exact)
    assert (err <= bound).all()
    assert err.max() < 2e-6 / 4
    for terms in (1, 2):
        assert np.abs(product(db, q, terms) - exact).max() > 2e-6


# ---------------------------------------------------------------------------
# the selection
# ---------------------------------------------------------------------------


def score_key(s):
    """The kernel's order-preserving key (-0 as +0); key 0: no row."""
    u = (np.asarray(s, np.float32) + np.float32(0)).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint64)


def pack(key, row):
    return (key << np.uint64(32)) | (~np.uint32(row)).astype(np.uint64)


def block_maxima(keys, mk=None):
    """The lanes' running block maxima (LANE_BLOCKS, 32) after one segment's
    keys (rows past it are key 0): block j of lane l holds rows l + 32i with
    i % 8 == j, over every segment so far."""
    n32 = -(-len(keys) // 32)
    padded = np.zeros(n32 * 32, np.uint64)
    padded[:len(keys)] = keys
    by_lane = padded.reshape(n32, 32)  # [i, lane]
    mk = np.zeros((LANE_BLOCKS, 32), np.uint64) if mk is None else mk.copy()
    for j in range(min(LANE_BLOCKS, n32)):
        mk[j] = np.maximum(mk[j], by_lane[j::LANE_BLOCKS].max(axis=0))
    return mk


def bit_search(values, k):
    """The TAU_BITS leading bits of the k-th largest value, bit by bit."""
    tau = 0
    for b in range(31, 31 - TAU_BITS, -1):
        cand = tau | (1 << b)
        if int((values >= cand).sum()) >= k:
            tau = cand
    return tau


def tau_of(keys, k, mk=None):
    """(τ, running block maxima) after one segment; beyond 256 wanted, each
    row of the segment is a block."""
    mk = block_maxima(keys, mk)
    t = bit_search(mk if k <= 32 * LANE_BLOCKS else keys, k)
    return max(t, 1), mk


def select_model(st, row0, n_valid, k, group, qc):
    """The kernel on Sᵀ, query by query and group by group; returns out_s,
    out_r (groups, qc, k) and the overflow count."""
    cap = 512
    while cap < 2 * k:
        cap *= 2
    rows = st.shape[0]
    groups = rows // group
    out_s = np.full((groups, qc, k), -np.inf, np.float32)
    out_r = np.zeros((groups, qc, k), np.int32)
    overflows = 0
    hi = np.uint64(32)
    for gi in range(groups):
        for q in range(qc):
            cand, tau, mk = np.zeros(0, np.uint64), 1, None
            for s0 in range(0, group, SEG_ROWS):
                ln = min(SEG_ROWS, group - s0)
                r = row0 + gi * group + s0 + np.arange(ln)
                keys = np.where(r < n_valid,
                                score_key(st[gi * group + s0:
                                             gi * group + s0 + ln, q]), 0)
                t, mk = tau_of(keys, k, mk)
                tau = max(tau, t)
                surv = pack(keys[keys >= tau], r[keys >= tau])
                if len(cand) + len(surv) > cap:
                    cand = cand[(cand >> hi) >= tau]
                if len(cand) + len(surv) <= cap:
                    cand = np.concatenate([cand, surv])
                    continue
                overflows += 1
                buf = np.zeros(k, np.uint64)
                top = np.sort(cand)[::-1][:k]
                buf[:len(top)] = top
                for e in surv:  # in row order, as the warp scans
                    least = int(np.argmin(buf))
                    if e > buf[least]:
                        buf[least] = e
                cand = buf[buf > 0]
            cand = np.sort(cand[(cand >> hi) >= tau])[::-1][:k]
            n = len(cand)
            keys = (cand >> hi).astype(np.uint32)
            u = np.where(keys & 0x80000000, keys & 0x7FFFFFFF, ~keys)
            out_s[gi, q, :n] = u.astype(np.uint32).view(np.float32)
            out_r[gi, q, :n] = (~(cand & np.uint64(0xFFFFFFFF)).astype(
                np.uint32)).view(np.int32)
    return out_s, out_r, overflows


def _plain(st, row0, n_valid, k, group, qc):
    groups = st.shape[0] // group
    out_s = torch.empty((groups, qc, k))
    out_r = torch.empty((groups, qc, k), dtype=torch.int32)
    F.select_groups_plain(torch.from_numpy(st), row0, n_valid, k, group,
                          out_s, out_r, 0, qc)
    return out_s.numpy(), out_r.numpy()


#: (scores, group, groups, k, n_valid, overflows expected): random scores
#: over three segments (a carry twice); ties at τ everywhere (integer scores
#: 0 and 1); n_valid inside group 1 and group 2 all padding; k = group; k
#: beyond the 256 blocks (single-row blocks) on one segment and on two
SELECT_CASES = [("random", 5000, 2, 100, 10000, False),
                ("tied", 3000, 3, 100, 4000, True),
                ("random", 64, 3, 64, 150, False),
                ("random", 1024, 2, 300, 2048, False),
                ("random", 4096, 1, 600, 4096, False),
                ("tied", 4096, 1, 1024, 4096, True)]


@pytest.mark.parametrize("kind,group,groups,k,n_valid,overflow",
                         SELECT_CASES)
def test_selection_model_equals_the_plain_selection(kind, group, groups, k,
                                                    n_valid, overflow):
    rng = np.random.default_rng(group + k)
    qc = 3
    shape = (group * groups, 8)
    st = (rng.standard_normal(shape) if kind == "random"
          else rng.integers(0, 2, shape)).astype(np.float32)
    got_s, got_r, overflows = select_model(st, 0, n_valid, k, group, qc)
    want_s, want_r = _plain(st, 0, n_valid, k, group, qc)
    np.testing.assert_array_equal(got_r, want_r)
    np.testing.assert_array_equal(got_s, want_s)
    assert (overflows > 0) == overflow


def test_tau_is_a_lower_bound_of_the_kth_best():
    """τ never exceeds a segment's k-th best key, at any k, on random and
    tied keys (the k-th largest of disjoint blocks' maxima is, and the bit
    search stops at or below it)."""
    rng = np.random.default_rng(5)
    for kind in ("random", "tied"):
        for ln in (40, 700, SEG_ROWS):
            s = (rng.standard_normal(ln) if kind == "random"
                 else rng.integers(-2, 3, ln)).astype(np.float32)
            keys = score_key(s)
            for k in (1, 10, 100, 256, 300):
                if k > ln:
                    continue
                kth = np.sort(keys)[::-1][k - 1]
                assert tau_of(keys, k)[0] <= kth
                # over two segments, with the blocks running across them
                mk = tau_of(keys[:ln // 2], k)[1]
                if k <= ln - ln // 2:
                    assert tau_of(keys[ln // 2:], k, mk)[0] <= kth


def test_keys_order_as_the_scores():
    s = np.float32([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, 7.25])
    keys = score_key(s)
    assert (np.diff(keys.astype(np.int64)) >= 0).all()
    assert keys[3] == keys[4]  # -0 and +0 tie
    assert keys[0] == 0x007FFFFF and keys.min() >= 1


# ---------------------------------------------------------------------------
# the merge
# ---------------------------------------------------------------------------


def _two_sort_merge(out_s, out_r, k):
    """The merge before the keyed one: rows first, then a stable score
    sort."""
    qn = out_s.shape[1]
    s = out_s.permute(1, 0, 2).reshape(qn, -1)
    r = out_r.permute(1, 0, 2).reshape(qn, -1)
    r, order = torch.sort(r, dim=1, stable=True)
    vals, pos = torch.sort(torch.gather(s, 1, order), dim=1,
                           descending=True, stable=True)
    return vals[:, :k], torch.gather(r, 1, pos[:, :k]).long()


@pytest.mark.parametrize("k", [1, 7, 40])
def test_keyed_merge_equals_the_two_sort_merge(k):
    """Integer scores (ties within and across slots), negative ones, -0.0
    beside 0.0, and empty slots (-inf, row 0) where a slot holds fewer than
    k rows; each row appears once."""
    rng = np.random.default_rng(k)
    slots, qn, per = 6, 4, 40
    rows = rng.permutation(10_000)[:slots * qn * per].reshape(slots, qn, per)
    s = rng.integers(-3, 4, (slots, qn, per)).astype(np.float32)
    s[s == 0] = np.where(rng.random((s == 0).sum()) < 0.5, 0.0, -0.0)
    s[1, :, per // 2:] = -np.inf
    rows[1, :, per // 2:] = 0
    out_s, out_r = torch.from_numpy(s), torch.from_numpy(rows.astype(np.int32))
    got = F._merge(out_s, out_r, k)
    want = _two_sort_merge(out_s, out_r, k)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


def test_keyed_merge_fills_with_empty_slots():
    """Fewer than k rows in all: the tail is (-inf, 0), as before."""
    s = torch.full((3, 1, 4), float("-inf"))
    r = torch.zeros((3, 1, 4), dtype=torch.int32)
    s[0, 0, :2] = torch.tensor([1.0, 1.0])
    r[0, 0, :2] = torch.tensor([9, 4], dtype=torch.int32)
    vals, rows = F._merge(s, r, 5)
    assert rows.tolist() == [[4, 9, 0, 0, 0]]
    assert vals[0, :2].tolist() == [1.0, 1.0]
    assert bool((vals[0, 2:] == float("-inf")).all())
    want = _two_sort_merge(s, r, 5)
    assert torch.equal(rows, want[1]) and torch.equal(vals, want[0])

"""The port's fused scan + top-k (wise_tpu_torch/ops/fused_topk.py) against
the Pallas kernels of wise_tpu/ops/pallas_topk.py, which run in interpret
mode here as tests/test_pallas_topk.py runs them. On CPU tensors the port's
wrappers compute their plain versions.

Tolerance: none. Vectors hold small integers (exact in bf16 too), so every
score is exact in f32 whatever the summation order, and rows and scores must
be identical. Where the Pallas kernels are the reference the scores are also
made distinct (two coordinates spell each row's rank in a seeded
permutation), because the TPU threshold kernel does not keep the engine's
order on ties: it evicts the first lane among tied worsts and orders final
ties by lane (its docstring says so). The port's kernels do keep it, (score
descending, row ascending), so the planted-tie cases hold them to
``wise_tpu.ops.topk.flat_topk`` instead.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wise_tpu.ops import pallas_topk as JP
from wise_tpu.ops import topk as J
from wise_tpu_torch.ops import fused_topk as F
from wise_tpu_torch.ops import topk as T

#: the cases of tests/test_pallas_topk.py (group kernel, threshold kernel)
GROUP_CASES = [(1000, 64, 3, 10, 256), (512, 128, 1, 100, 256),
               (300, 32, 2, 7, 128), (64, 16, 1, 64, 64)]
THRESHOLD_CASES = [(1000, 64, 3, 10, 256), (512, 128, 1, 100, 256),
                   (300, 32, 2, 7, 128), (2048, 32, 4, 128, 256)]


def _distinct_case(seed, n, d, q, group):
    """Integer vectors with distinct scores for each query: coordinates 0
    and 1 spell a permutation rank (a * 64 + b), the others weigh 4096 a
    unit. Query 0 scores every row negative, so unmasked zero padding would
    win."""
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
    rng = np.random.default_rng(seed)
    db = rng.integers(-3, 4, (n, d)).astype(np.float32)
    db[n // 2] = db[3]            # duplicates across groups
    db[n - 1] = db[3]
    db[7:7 + 5] = db[40 % n]      # a run of ties inside one tile
    queries = rng.integers(-2, 3, (q, d)).astype(np.float32)
    queries[0] = -np.abs(queries[0])
    db_pad = np.zeros((-(-n // group) * group, d), np.float32)
    db_pad[:n] = db
    return queries, db_pad


def _same(got, want):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("n,d,q,k,group", GROUP_CASES)
def test_fused_topk_matches_pallas(n, d, q, k, group):
    queries, db_pad = _distinct_case(n, n, d, q, group)
    want = JP.pallas_topk(jnp.asarray(queries), jnp.asarray(db_pad),
                          n_valid=n, k=k, group=group, interpret=True)
    got = F.fused_topk(torch.from_numpy(queries), torch.from_numpy(db_pad),
                       n, k, group)
    _same(got, want)
    assert int(got[1].max()) < n


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,q,k,group", THRESHOLD_CASES)
def test_fused_topk_threshold_matches_pallas(n, d, q, k, group, storage):
    queries, db_pad = _distinct_case(n + 1, n, d, q, group)
    want = JP.pallas_topk_threshold(
        jnp.asarray(queries), jnp.asarray(db_pad, getattr(jnp, storage)),
        n_valid=n, k=k, group=group, interpret=True)
    got = F.fused_topk_threshold(
        torch.from_numpy(queries),
        torch.from_numpy(db_pad).to(getattr(torch, storage)), n, k, group)
    _same(got, want)
    assert int(got[1].max()) < n


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["fused_topk", "fused_topk_threshold"])
@pytest.mark.parametrize("n,d,q,k,group", [
    (1000, 16, 3, 10, 256),      # ties across groups and inside a tile
    (512, 8, 1, 100, 256),       # the k-th boundary falls among ties
    (50, 4, 2, 50, 64),          # k == n_valid: every row, ties everywhere
    (3000, 8, 9, 64, 512),       # more queries than a tile of 8
])
def test_planted_ties_keep_the_engine_order(n, d, q, k, group, fn, storage):
    """Held to flat_topk's (score descending, row ascending), not to the
    TPU threshold kernel's lane order."""
    queries, db_pad = _tied_case(n + q, n, d, q, group)
    want = J.flat_topk(jnp.asarray(queries),
                       jnp.asarray(db_pad, getattr(jnp, storage)),
                       n_valid=n, k=k, group=group)
    tdb = torch.from_numpy(db_pad).to(getattr(torch, storage))
    got = getattr(F, fn)(torch.from_numpy(queries), tdb, n, k, group)
    _same(got, want)
    _same(getattr(F, fn + "_plain")(torch.from_numpy(queries), tdb, n, k,
                                    group), want)


def test_fewer_valid_rows_than_k():
    queries, db_pad = _tied_case(5, 6, 8, 2, 64)
    for fn in (F.fused_topk, F.fused_topk_threshold):
        vals, rows = fn(torch.from_numpy(queries), torch.from_numpy(db_pad),
                        6, 10, 64)
        assert vals.shape == rows.shape == (2, 6)
        assert sorted(rows[0].tolist()) == list(range(6))
        assert bool(torch.isfinite(vals).all())


def test_scan_topk_matches_reference():
    queries, db_pad = _tied_case(11, 700, 16, 3, 256)
    db = db_pad[:700]
    for kw in ({}, {"n_valid": 650}):
        want = J.scan_topk(jnp.asarray(queries), jnp.asarray(db), k=20,
                           block_rows=256, **kw)
        got = T.scan_topk(torch.from_numpy(queries), torch.from_numpy(db),
                          k=20, block_rows=256, **kw)
        _same(got, want)


def test_wrappers_reject_bad_shapes_on_cpu_too():
    db = torch.zeros(100, 8)
    with pytest.raises(ValueError, match="multiple of group"):
        F.fused_topk(torch.zeros(1, 8), db, 100, 5, 64)
    with pytest.raises(ValueError, match="k "):
        F.fused_topk_threshold(torch.zeros(1, 8), torch.zeros(128, 8), 128,
                               100, 64)


def test_launch_counter_untouched_on_cpu():
    F.reset_launches()
    F.fused_topk(torch.zeros(1, 8), torch.zeros(64, 8), 64, 5, 64)
    assert F.LAUNCHES == {"fused_topk": 0, "fused_topk_threshold": 0}
    assert F.LAUNCHES_BY_SHAPE == {}

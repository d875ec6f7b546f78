"""The host side of ``fused_topk``'s group path
(wise_tpu_torch/ops/fused_topk.py ``group_topk_chunks``) on both storage
types: query rounding (bf16 storage only) and padding, chunks of queries and
of whole groups, the Sᵀ scratch layout, the n_valid mask and the merge, with
the two kernels replaced by their plain versions (``scores_t_plain`` /
``scores_t_f32_plain``: Sᵀ from ``ops.topk._scores``;
``select_groups_plain``: each group's stable top-k). The kernels themselves
are held on the card by tests/test_torch_kernels_cuda.py.

Reference: wise_tpu/ops/pallas_topk.py ``pallas_topk`` in interpret mode on
the distinct-score cases of tests/test_torch_fused_topk.py (the TPU kernel
orders ties by lane), and ``wise_tpu.ops.topk.flat_topk`` on planted ties.
Tolerance: none. The vectors hold small integers, exact in bf16, so every
score is exact in f32 whatever the summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_fused_topk import GROUP_CASES, _distinct_case, _tied_case
from wise_tpu.ops import pallas_topk as JP
from wise_tpu.ops import topk as J
from wise_tpu_torch.ops import fused_topk as F


def _chunks(queries, db_pad, n_valid, k, group, chunk_queries, chunk_groups,
            calls=None, storage=torch.bfloat16):
    """group_topk_chunks on the plain halves with the chunks forced small:
    ``chunk_queries`` queries and ``chunk_groups`` groups of Sᵀ at a time.
    ``calls`` collects (rows, Q_pad, q0, qc) of every chunk."""
    width = -(-min(queries.shape[0], chunk_queries) // 8) * 8
    bf16 = storage == torch.bfloat16

    def product(db_rows, op, st):
        assert db_rows.dtype == op.dtype == storage
        # bf16: Wq = bf16(q)ᵀ (D, Q_pad); f32: the queries as they are
        shape = (db_pad.shape[1], st.shape[1]) if bf16 else \
            (st.shape[1], db_pad.shape[1])
        assert op.shape == shape
        assert st.dtype == torch.float32 and st.is_contiguous()
        assert st.shape[0] == db_rows.shape[0] and st.shape[1] % 8 == 0
        (F.scores_t_plain if bf16 else F.scores_t_f32_plain)(db_rows, op, st)

    def select(st, row0, n_valid, k, group, out_s, out_r, q0, qc):
        assert row0 % group == 0 and st.shape[0] % group == 0
        assert st.shape[0] // group <= chunk_groups and qc <= chunk_queries
        if calls is not None:
            calls.append((st.shape[0], st.shape[1], q0, qc))
        F.select_groups_plain(st, row0, n_valid, k, group, out_s, out_r, q0,
                              qc)

    return F.group_topk_chunks(
        torch.from_numpy(queries), torch.from_numpy(db_pad).to(storage),
        n_valid, k, group, product, select, chunk_queries=chunk_queries,
        scratch_bytes=4 * group * width * chunk_groups)


def _same(got, want):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("storage", ["bfloat16", "float32"])
@pytest.mark.parametrize("n,d,q,k,group", GROUP_CASES)
def test_chunks_match_pallas(n, d, q, k, group, storage):
    queries, db_pad = _distinct_case(n, n, d, q, group)
    want = JP.pallas_topk(jnp.asarray(queries),
                          jnp.asarray(db_pad, getattr(jnp, storage)),
                          n_valid=n, k=k, group=group, interpret=True)
    _same(_chunks(queries, db_pad, n, k, group, 2, 1,
                  storage=getattr(torch, storage)), want)


@pytest.mark.parametrize("q", [1, 3, 9, 70])
def test_ragged_queries_split_both_ways(q):
    """Chunks of 2 queries (each padded to 8 columns) by 2 groups: every
    ragged Q splits rows, Q > 2 queries too."""
    n, d, k, group = 700, 16, 20, 128
    queries, db_pad = _tied_case(q + 100, n, d, q, group)
    want = J.flat_topk(jnp.asarray(queries), jnp.asarray(db_pad, jnp.bfloat16),
                       n_valid=n, k=k, group=group)
    calls = []
    _same(_chunks(queries, db_pad, n, k, group, 2, 2, calls), want)
    groups = db_pad.shape[0] // group
    assert len(calls) == -(-q // 2) * -(-groups // 2)
    assert {c[1] for c in calls} == {8}
    assert sorted((c[2], c[3]) for c in calls)[-1] == ((q - 1) // 2 * 2,
                                                       q - (q - 1) // 2 * 2)


def test_last_chunk_all_padding():
    """n_valid ends inside group 2 of 5: groups 3 and 4, each a chunk of its
    own, hold no valid row, and the rows past n_valid (rows of data, then
    zeros, which outscore query 0's negative true scores) stay out."""
    n, d, q, k, group = 300, 8, 4, 30, 64
    queries, db = _tied_case(7, n, d, q, group)
    db_pad = np.zeros((5 * group, d), np.float32)
    db_pad[:n] = db[:n]
    n_valid = 2 * group + 10
    want = J.flat_topk(jnp.asarray(queries), jnp.asarray(db_pad, jnp.bfloat16),
                       n_valid=n_valid, k=k, group=group)
    got = _chunks(queries, db_pad, n_valid, k, group, 8, 1)
    _same(got, want)
    assert int(got[1].max()) < n_valid


def test_select_leaves_empty_slots_as_the_kernel_does():
    """A group with no valid row gives (-inf, row 0) in every slot, as
    wt_topk_select's empty buffer entries do."""
    group, k, q_pad = 16, 4, 8
    st = torch.arange(3 * group * q_pad, dtype=torch.float32).reshape(
        3 * group, q_pad)
    out_s = torch.full((3, 5, k), 7.0)
    out_r = torch.full((3, 5, k), 7, dtype=torch.int32)
    F.select_groups_plain(st, 0, group + 2, k, group, out_s, out_r, 1, 3)
    assert torch.equal(out_r[2, 1:4], torch.zeros(3, k, dtype=torch.int32))
    assert bool((out_s[2, 1:4] == float("-inf")).all())
    # group 1 has rows 16 and 17 valid: two entries, then empty slots
    assert out_r[1, 1].tolist() == [17, 16, 0, 0]
    # queries outside [1, 4) are not written
    assert bool((out_s[:, 0] == 7).all()) and bool((out_s[:, 4] == 7).all())


def test_k_equals_group():
    n, d, q, group = 200, 8, 3, 64
    queries, db_pad = _tied_case(3, n, d, q, group)
    want = J.flat_topk(jnp.asarray(queries), jnp.asarray(db_pad, jnp.bfloat16),
                       n_valid=n, k=group, group=group)
    _same(_chunks(queries, db_pad, n, group, group, 2, 1), want)


def test_bf16_cpu_wrapper_agrees_with_the_chunked_host_path():
    """fused_topk on a CPU bf16 database (its plain version) and the chunked
    host path with default chunks give one result."""
    n, d, q, k, group = 1000, 16, 9, 64, 256
    queries, db_pad = _tied_case(11, n, d, q, group)
    tq, tdb = torch.from_numpy(queries), torch.from_numpy(db_pad).bfloat16()
    got = F.group_topk_chunks(tq, tdb, n, k, group, F.scores_t_plain,
                              F.select_groups_plain)
    want = F.fused_topk(tq, tdb, n, k, group)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

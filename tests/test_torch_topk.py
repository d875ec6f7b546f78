"""The port's exact flat top-k (wise_tpu_torch/ops/topk.py) against the JAX
package's ``flat_topk``: identical ids and scores, including planted ties
(faiss order: the lower row first) and zero padding rows that would
outscore negative true scores unless masked by n_valid.

Vectors hold small integers, so every score is exact in f32 (and in bf16
storage) and the comparison is exact, whatever the summation order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wise_tpu.ops import topk as J
from wise_tpu_torch.ops import topk as T


def _case(seed, n, d, q, group):
    rng = np.random.default_rng(seed)
    db = rng.integers(-3, 4, (n, d)).astype(np.float32)
    db[n // 2] = db[3]            # planted duplicate rows: tied scores
    db[n - 1] = db[3]
    db[7:7 + 5] = db[40 % n]      # a run of ties inside one block
    queries = rng.integers(-2, 3, (q, d)).astype(np.float32)
    queries[0] = -np.abs(queries[0])  # negative scores vs zero padding
    db_pad = np.zeros((-(-n // group) * group, d), np.float32)
    db_pad[:n] = db
    return queries, db_pad


@pytest.mark.parametrize(
    "n,d,q,k,group",
    [
        (1000, 16, 1, 10, 256),     # serve shape: one query, two-stage
        (1000, 16, 16, 100, 256),   # hier path in the reference
        (3000, 8, 130, 10, 512),    # Q > 128
        (600, 8, 3, 300, 128),      # k > group: one stable sort
        (50, 4, 2, 50, 64),         # k == n_valid, ties everywhere
    ],
)
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_flat_topk_matches_reference(n, d, q, k, group, storage):
    queries, db_pad = _case(n + q, n, d, q, group)
    jdb = jnp.asarray(db_pad, getattr(jnp, storage))
    want_v, want_i = J.flat_topk(jnp.asarray(queries), jdb, n_valid=n, k=k,
                                 group=group)
    tdb = torch.from_numpy(db_pad).to(getattr(torch, storage))
    got_v, got_i = T.flat_topk(torch.from_numpy(queries), tdb, n_valid=n,
                               k=k, group=group)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert int(got_i.max()) < n     # no padding row is ever returned


def test_pad_rows():
    db = torch.ones(5, 3)
    out = T.pad_rows(db, 4)
    assert out.shape == (8, 3) and torch.equal(out[:5], db)
    assert not out[5:].any()
    assert T.pad_rows(torch.ones(8, 3), 4).shape == (8, 3)
    assert T.pad_rows(torch.ones(0, 3), 4).shape == (4, 3)

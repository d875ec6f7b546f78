"""int8 storage and the approximate flat search of the port
(wise_tpu_torch/ops/topk.py, index/feature_index.py) against the JAX
package.

Tolerances:
- ``quantize_rows_int8`` and ``rerank_exact_f32`` are numpy copies: equal.
- ``int8_candidates``: on integer-valued vectors every query and row scale
  is a power-of-two multiple of 1/127 and every integer sum is exact, so
  candidate rows and scores are identical to JAX's.
- int8 ``FeatureSearchIndex``: ids equal to the f32 index's and to the JAX
  int8 index's on well-separated unit vectors; scores within 3e-5 relative
  (true f32 dots; BLAS accumulation order).
- ``flat_topk_approx``: the JAX function is exact on the CPU, so the port is
  held to recall@k >= recall_target against the exact result on seeded
  unordered data, and every returned (score, row) pair must be a true one
  (score equal to the exact scan's score of that row).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_index import _build_project_store
from wise_tpu.config import IndexConfig as JIndexConfig
from wise_tpu.index import FeatureSearchIndex as JIndex
from wise_tpu.ops import topk as J
from wise_tpu_torch.config import IndexConfig
from wise_tpu_torch.index.feature_index import FeatureSearchIndex
from wise_tpu_torch.ops import topk as T


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("WISE_TORCH_DEVICE", "cpu")


def test_quantize_rows_int8_equal(rng):
    db = rng.standard_normal((300, 48)).astype(np.float32)
    db[5] = 0
    (jc, js), (tc, ts) = J.quantize_rows_int8(db), T.quantize_rows_int8(db)
    np.testing.assert_array_equal(jc, tc)
    np.testing.assert_array_equal(js, ts)
    assert ts[5] == 0 and not tc[5].any()


@pytest.mark.parametrize("n,d,q,kc,k,group", [
    (1000, 32, 3, 40, 10, 256),
    (600, 16, 1, 400, 100, 128),    # kc spans several groups
    (90, 8, 2, 90, 30, 64),         # kc == n_valid
])
def test_int8_candidates_identical(n, d, q, kc, k, group):
    rng = np.random.default_rng(n)
    # integer rows whose absmax is 127: scale exactly 1, codes the rows
    db = rng.integers(-127, 128, (n, d)).astype(np.float32)
    db[:, 0] = 127
    db[n // 2] = db[3]
    queries = rng.integers(-127, 128, (q, d)).astype(np.float32)
    queries[:, 1] = -127
    pad = np.zeros((-(-n // group) * group, d), np.float32)
    pad[:n] = db
    codes, scales = T.quantize_rows_int8(pad)
    want_v, want_r = J.int8_candidates(
        jnp.asarray(queries), jnp.asarray(codes), jnp.asarray(scales),
        n_valid=n, kc=kc, k=k, group=group)
    got_v, got_r = T.int8_candidates(
        torch.from_numpy(queries), torch.from_numpy(codes),
        torch.from_numpy(scales), n_valid=n, kc=kc, k=k, group=group)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    bf = J.int8_candidates_bf16dot(
        jnp.asarray(queries), jnp.asarray(codes), jnp.asarray(scales),
        n_valid=n, kc=kc, k=k, group=group)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(bf[1]))


def test_rerank_exact_f32_equal(rng):
    vecs = rng.standard_normal((200, 16)).astype(np.float32)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    cand = rng.integers(-1, 230, (3, 40))       # duplicates, -1, padding rows
    want = J.rerank_exact_f32(q, cand, vecs, 10, n_valid=200)
    got = T.rerank_exact_f32(q, cand, vecs, 10, n_valid=200)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_numpy_reference_topk_equal(rng):
    db = rng.standard_normal((50, 8)).astype(np.float32)
    q = rng.standard_normal((2, 8)).astype(np.float32)
    for a, b in zip(T.numpy_reference_topk(q, db, 7),
                    J.numpy_reference_topk(q, db, 7)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [5, 40])
def test_int8_index_equals_f32_and_jax(tmp_path, k):
    asset, ids, vecs = _build_project_store(tmp_path, n=700, dim=32, seed=3)
    fid = "wise/random_features/32/test"
    flat = FeatureSearchIndex("video", fid, asset, config=IndexConfig())
    assert flat.create_index("IndexFlatIP", overwrite=True)
    q = np.random.default_rng(8).standard_normal((4, 32)).astype(np.float32)
    out = {}
    for name, cls, cfg in (("f32", FeatureSearchIndex, IndexConfig()),
                           ("int8", FeatureSearchIndex,
                            IndexConfig(storage_dtype="int8")),
                           ("jax", JIndex,
                            JIndexConfig(storage_dtype="int8"))):
        idx = cls("video", fid, asset, config=cfg)
        assert idx.load_index("IndexFlatIP")
        out[name] = idx.search_batch(q, k)
        # the coalescer's two-phase call gives the same rows
        handle = idx.search_batch_dispatch(q, k)
        v, i = idx.search_batch_finalize(handle, 2)
        np.testing.assert_array_equal(i, out[name][1][2])
    np.testing.assert_array_equal(out["int8"][1], out["f32"][1])
    np.testing.assert_array_equal(out["int8"][1], out["jax"][1])
    np.testing.assert_allclose(out["int8"][0], out["f32"][0], rtol=3e-5)
    np.testing.assert_allclose(out["int8"][0], out["jax"][0], rtol=3e-5)


def test_int8_with_approx_recall_stays_int8(tmp_path, caplog):
    asset, ids, vecs = _build_project_store(tmp_path, n=300, dim=16, seed=5)
    fid = "wise/random_features/16/test"
    idx = FeatureSearchIndex("video", fid, asset, config=IndexConfig(
        storage_dtype="int8", flat_approx_recall=0.9))
    assert idx.create_index("IndexFlatIP", overwrite=True)
    assert idx.load_index("IndexFlatIP")
    with caplog.at_level("WARNING"):
        scores, got = idx.search_batch(vecs[:3], 5)
        idx.search_batch(vecs[:3], 5)
    assert got[:, 0].tolist() == ids[:3].tolist()
    assert sum("flat_approx_recall" in r.message
               for r in caplog.records) == 1


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,target", [(10, 0.9), (50, 0.95)])
def test_flat_topk_approx_recall(k, target, storage):
    rng = np.random.default_rng(k)
    n, d, nq, group = 4000, 32, 64, 4096
    db = rng.standard_normal((n, d)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    queries = rng.standard_normal((nq, d)).astype(np.float32)
    pad = np.zeros((group, d), np.float32)
    pad[:n] = db
    tdb = torch.from_numpy(pad).to(getattr(torch, storage))
    tq = torch.from_numpy(queries)
    buckets = T.approx_buckets(group, k, target)
    assert k <= buckets < group and group % buckets == 0
    got_v, got_r = T.flat_topk_approx(tq, tdb, n_valid=n, k=k,
                                      recall_target=target)
    assert got_v.shape == got_r.shape == (nq, k)
    # the JAX function on the CPU is the exact scan
    want_v, want_r = J.flat_topk_approx(
        jnp.asarray(queries), jnp.asarray(pad, getattr(jnp, storage)),
        n_valid=n, k=k, recall_target=target)
    want_r = np.asarray(want_r)
    hits = sum(len(set(g) & set(w))
               for g, w in zip(got_r.numpy().tolist(), want_r.tolist()))
    assert hits / (nq * k) >= target
    assert hits < nq * k            # it is approximate: buckets do collide
    # every pair is a true one, in (score descending, row ascending) order
    exact = T._masked_scores(tq, tdb, n)
    np.testing.assert_array_equal(
        got_v.numpy(), torch.gather(exact, 1, got_r).numpy())
    assert int(got_r.max()) < n
    assert bool((got_v[:, :-1] >= got_v[:, 1:]).all())
    # recall 1.0 is the exact scan
    full_v, full_r = T.flat_topk_approx(tq, tdb, n_valid=n, k=k,
                                        recall_target=1.0)
    np.testing.assert_array_equal(full_r.numpy(), want_r)


def test_approx_index_search(tmp_path):
    asset, ids, vecs = _build_project_store(tmp_path, n=900, dim=32, seed=6)
    fid = "wise/random_features/32/test"
    exact = FeatureSearchIndex("video", fid, asset, config=IndexConfig())
    assert exact.create_index("IndexFlatIP", overwrite=True)
    assert exact.load_index("IndexFlatIP")
    approx = FeatureSearchIndex("video", fid, asset, config=IndexConfig(
        flat_approx_recall=0.9))
    assert approx.load_index("IndexFlatIP")
    q = np.random.default_rng(1).standard_normal((32, 32)).astype(np.float32)
    _, want = exact.search_batch(q, 10)
    scores, got = approx.search_batch(q, 10)
    hits = sum(len(set(g) & set(w)) for g, w in zip(got.tolist(),
                                                    want.tolist()))
    assert hits / want.size >= 0.9
    handle = approx.search_batch_dispatch(q, 10)
    np.testing.assert_array_equal(approx.search_batch_finalize(handle, 3)[1],
                                  got[3])

"""The port's IVF-PQ (wise_tpu_torch/ops/pq.py, ops/ivf_paged.py
``paged_pq_core``, the IVF-PQ half of index/feature_index.py) against the
JAX package.

Tolerances:
- ``train_pq`` / ``train_opq`` from the same seed (both k-means draw their
  initial centroids from ``np.random.default_rng(seed)``): codebooks and
  rotation within 1e-4, and ``encode_pq``'s codes equal on at least 99.9% of
  rows (a near-tie in an argmin may flip). ``encode_pq``, ``decode_pq``,
  ``adc_tables`` and ``adc_scores`` are numpy copies: equal on equal inputs.
- ``paged_pq_core`` against the reference's ``ivfpq_search_paged`` on the
  CPU (``ops.fused_topk.topk_agreement``): scores within 1e-5 position by
  position, rows equal except swaps between scores within 1e-5.
- ``.widx`` files: an IVF-PQ file built by either package holds the same
  keys and header, integer arrays equal and float arrays within 1e-4; each
  package searches the other's file with the writer's own results (rows as
  above), with the flat-sibling rerank, the int8 refine rerank and none.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_index import _build_project_store
from wise_tpu.config import IndexConfig as JIndexConfig
from wise_tpu.index import FeatureSearchIndex as JIndex
from wise_tpu.index.format import read_index_file
from wise_tpu.ops import ivf_paged as JP
from wise_tpu.ops import kmeans as JK
from wise_tpu.ops import pq as JQ
from wise_tpu_torch.config import IndexConfig
from wise_tpu_torch.index.feature_index import FeatureSearchIndex
from wise_tpu_torch.ops import ivf_paged as TP
from wise_tpu_torch.ops import pq as TQ
from wise_tpu_torch.ops.fused_topk import topk_agreement

FID = "wise/random_features/32/test"
TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("WISE_TORCH_DEVICE", "cpu")


def _clustered(seed, n, d, cells):
    rng = np.random.default_rng(seed)
    centers = 3.0 * rng.standard_normal((cells, d)).astype(np.float32)
    x = centers[rng.integers(0, cells, n)] + 0.3 * rng.standard_normal(
        (n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _codes_agree(got, want):
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    rows_equal = (got == want).all(axis=1).mean()
    assert rows_equal >= 0.999, rows_equal


@pytest.mark.parametrize("n,d,m,ksub", [(3000, 64, 8, 256), (2000, 128, 4, 16),
                                        (200, 64, 8, 256)])
def test_train_pq_matches_reference(n, d, m, ksub):
    """(200 rows: ksub > n, each book zero-padded past its n entries.)"""
    x = _clustered(1, n, d, 20)
    want = JQ.train_pq(x, m, ksub, iters=6, seed=3)
    got = TQ.train_pq(x, m, ksub, iters=6, seed=3)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)
    _codes_agree(TQ.encode_pq(x, got), JQ.encode_pq(x, want))


@pytest.mark.parametrize("d,m,ksub", [(64, 8, 256), (128, 4, 16)])
def test_train_opq_matches_reference(d, m, ksub):
    x = _clustered(2, 2500, d, 16)
    x = x - x.mean(axis=0)
    want_r, want_b = JQ.train_opq(x, m, ksub, iters=5, opq_iters=3,
                                  sample=1500)
    got_r, got_b = TQ.train_opq(x, m, ksub, iters=5, opq_iters=3,
                                sample=1500)
    assert got_r.dtype == got_b.dtype == np.float32
    np.testing.assert_allclose(got_r, want_r, atol=1e-4)
    np.testing.assert_allclose(got_b, want_b, atol=1e-4)
    np.testing.assert_allclose(got_r @ got_r.T, np.eye(d), atol=1e-4)
    _codes_agree(TQ.encode_pq(x @ got_r, got_b),
                 JQ.encode_pq(x @ want_r, want_b))


def test_encode_decode_adc_equal_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1000, 64)).astype(np.float32)
    books = rng.standard_normal((8, 256, 8)).astype(np.float32)
    codes = TQ.encode_pq(x, books)
    np.testing.assert_array_equal(codes, JQ.encode_pq(x, books))
    np.testing.assert_array_equal(TQ.decode_pq(codes, books),
                                  JQ.decode_pq(codes, books))
    q = rng.standard_normal(64).astype(np.float32)
    tables = TQ.adc_tables(q, books)
    np.testing.assert_array_equal(tables, JQ.adc_tables(q, books))
    np.testing.assert_array_equal(TQ.adc_scores(codes, tables),
                                  JQ.adc_scores(codes, tables))
    with pytest.raises(ValueError, match="not divisible"):
        TQ.train_pq(x[:, :60], 8)
    with pytest.raises(ValueError, match="ksub=512"):
        TQ.encode_pq(x, np.zeros((8, 512, 8), np.float32))


def _pq_layout(seed, opq, n=1500, d=64, nlist=14, m=8, lpad=16):
    """Cell-sorted codes of clustered unit vectors, paged; with ``opq`` the
    centroids and residuals rotated as the index stores them. Returns the
    layout, the (rotated) centroids, the codebooks and the rotation."""
    x = _clustered(seed, n, d, 10)
    cent, assign = JK.kmeans(x, nlist, iters=6, seed=0)
    perm = np.argsort(assign, kind="stable")
    offsets = np.zeros(nlist + 1, np.int64)
    np.cumsum(np.bincount(assign, minlength=nlist), out=offsets[1:])
    resid = (x - cent[assign])[perm]
    rot = np.eye(d, dtype=np.float32)
    if opq:
        rot, books = JQ.train_opq(resid, m, 64, iters=4, opq_iters=2)
    else:
        books = JQ.train_pq(resid, m, 64, iters=4)
    codes = JQ.encode_pq(resid @ rot, books)
    lay = JP.build_paged_layout(codes, offsets, lpad)
    return lay, (cent @ rot).astype(np.float32), books, rot


@pytest.mark.parametrize("opq", [False, True])
@pytest.mark.parametrize("nprobe,chunk,k", [(3, 2, 10), (14, 5, 25),
                                            (14, 1000, 10), (6, 1, 40)])
def test_paged_pq_core_matches_reference(nprobe, chunk, k, opq):
    lay, cent, books, rot = _pq_layout(5, opq)
    assert lay["paged"].dtype == np.uint8
    budget = TP.paged_budget(lay["page_count"], nprobe)
    chunk = min(chunk, budget)
    q = (_clustered(6, 7, 64, 10) @ rot).astype(np.float32)
    want_v, want_r = JP.ivfpq_search_paged(
        jnp.asarray(q), jnp.asarray(cent), jnp.asarray(lay["page_first"]),
        jnp.asarray(lay["page_count"]), jnp.asarray(lay["paged"]),
        jnp.asarray(lay["page_rows"]), jnp.asarray(books), nprobe=nprobe,
        budget=budget, chunk=chunk, k=k)
    t = {name: torch.from_numpy(a) for name, a in lay.items()}
    got_v, got_r = TP.ivfpq_search_paged(
        torch.from_numpy(q), torch.from_numpy(cent), t["page_first"],
        t["page_count"], t["paged"], t["page_rows"], torch.from_numpy(books),
        nprobe=nprobe, budget=budget, chunk=chunk, k=k)
    assert got_v.dtype == torch.float32 and got_r.dtype == torch.int64
    check = topk_agreement((got_v, got_r), (torch.from_numpy(np.array(
        want_v)), torch.from_numpy(np.array(want_r))), tol=TOL)
    assert check["ok"], check
    # every probed lane scored: no empty slot unless the probe is short
    if nprobe == 14:
        assert not torch.isinf(got_v).any()


def _index(pkg, asset, **cfg):
    cfg = {"pq_train_samples": 900, **cfg}
    if pkg == "jax":
        return JIndex("video", FID, asset, config=JIndexConfig(**cfg))
    return FeatureSearchIndex("video", FID, asset, config=IndexConfig(**cfg))


def _rows(scores, ids, all_ids):
    """(scores, result ids) -> tensors of the scores and each id's position
    in ``all_ids`` (-1 for an empty slot), which topk_agreement compares."""
    order = np.argsort(all_ids)
    rows = order[np.searchsorted(all_ids[order], ids)]
    rows[ids < 0] = -1
    return torch.from_numpy(np.array(scores)), torch.from_numpy(rows)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
@pytest.mark.parametrize("rerank", ["flat", "refine", "none"])
def test_widx_written_by_one_searched_by_the_other(tmp_path, writer, reader,
                                                   rerank):
    asset, ids, vecs = _build_project_store(tmp_path, n=900, dim=32, seed=7)
    w = _index(writer, asset)
    assert w.create_index("IndexIVFPQ", overwrite=True)
    meta, arrays = read_index_file(w.index_path("IndexIVFPQ"))
    assert meta["index_type"] == "IndexIVFPQ" and meta["pq_m"] == 8
    assert set(arrays) == {"ids", "codes", "centroids", "pq_codebooks",
                           "cell_offsets", "opq_rotation", "refine_codes",
                           "refine_scales"}
    if rerank == "flat":
        assert _index("torch", asset).create_index("IndexFlatIP")
    q = np.random.default_rng(2).standard_normal((6, 32)).astype(np.float32)
    out = {}
    for pkg in (writer, reader):
        for nprobe in (4, 10_000):
            idx = _index(pkg, asset, nprobe=nprobe,
                         pq_exact_rerank=rerank != "none")
            assert idx.load_index("IndexIVFPQ")
            out[pkg, nprobe] = idx.search_batch(q, 10)
    for nprobe in (4, 10_000):
        got, want = out[reader, nprobe], out[writer, nprobe]
        check = topk_agreement(_rows(*got, ids), _rows(*want, ids), tol=TOL)
        assert check["ok"], (nprobe, check)
        assert (got[1] >= 0).all()
    if rerank == "flat":
        # the flat rerank's scores are exact inner products
        np.testing.assert_allclose(
            out[reader, 10_000][0],
            np.take_along_axis(q @ vecs.T, out[reader, 10_000][1] - 1, 1),
            atol=1e-5)


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("opq", [True, False])
def test_both_packages_build_the_same_file(tmp_path, stream, opq):
    asset, ids, vecs = _build_project_store(tmp_path, n=800, dim=32, seed=4)
    cfg = dict(stream_build_threshold_bytes=0 if stream else 1 << 40,
               pq_opq=opq, pq_refine="int8" if opq else "none")
    files = {}
    for pkg in ("jax", "torch"):
        idx = _index(pkg, asset, **cfg)
        assert idx.create_index("IndexIVFPQ", overwrite=True)
        files[pkg] = read_index_file(idx.index_path("IndexIVFPQ"),
                                     mmap_arrays=False)
    (jm, ja), (tm, ta) = files["jax"], files["torch"]
    assert tm == jm and set(ta) == set(ja)
    assert ("opq_rotation" in ta) == opq and ("refine_codes" in ta) == opq
    for name in ja:
        assert ta[name].dtype == ja[name].dtype, name
        if ja[name].dtype.kind == "f":
            np.testing.assert_allclose(ta[name], ja[name], atol=1e-4,
                                       err_msg=name)
        elif name == "codes":
            _codes_agree(ta[name], ja[name])
        else:
            np.testing.assert_array_equal(ta[name], ja[name], err_msg=name)


@pytest.mark.parametrize("refine,opq", [("int8", True), ("none", True),
                                        ("none", False)])
def test_reconstruct_rows_matches_reference(tmp_path, refine, opq):
    asset, ids, vecs = _build_project_store(tmp_path, n=600, dim=32, seed=5)
    cfg = dict(pq_refine=refine, pq_opq=opq)
    assert _index("torch", asset, **cfg).create_index("IndexIVFPQ")
    rows = np.array([0, 17, 599, 300, 17])
    out = {}
    for pkg in ("jax", "torch"):
        idx = _index(pkg, asset, **cfg)
        assert idx.load_index("IndexIVFPQ")
        out[pkg] = idx.reconstruct_rows(rows)
    assert out["torch"].dtype == np.float32 and out["torch"].shape == (5, 32)
    np.testing.assert_allclose(out["torch"], out["jax"], atol=1e-5)
    # the stored rows are cell-sorted: reconstructions approximate them
    stored = vecs[np.asarray(read_index_file(
        _index("torch", asset).index_path("IndexIVFPQ"))[1]["ids"])[rows] - 1]
    err = np.linalg.norm(out["torch"] - stored, axis=1)
    assert err.max() < (0.02 if refine == "int8" else 0.9), err


def test_device_path_matches_host_adc(tmp_path):
    """The port's paged ADC against its numpy host ADC (the check the chip
    smoke makes at 1M), at partial and full probes, with OPQ."""
    asset, ids, vecs = _build_project_store(tmp_path, n=700, dim=32, seed=8)
    idx = _index("torch", asset, pq_exact_rerank=False)
    assert idx.create_index("IndexIVFPQ")
    assert idx.load_index("IndexIVFPQ")
    pg = idx._ensure_pq_paged()
    assert [p.dtype for p in pg["paged"]] == [torch.uint8]   # one shard
    assert [c.dtype for c in pg["codebooks"]] == [torch.float32]
    q = np.concatenate([vecs[3:5], np.random.default_rng(1).standard_normal(
        (2, 32)).astype(np.float32)])
    for nprobe in (1, 4, 10_000):
        for k in (10, 700):
            got = idx._search_ivfpq_device(q, k, nprobe)
            want = idx._search_ivfpq_host(q, k, nprobe)
            check = topk_agreement(tuple(map(torch.from_numpy, got)),
                                   tuple(map(torch.from_numpy, want)),
                                   tol=TOL)
            assert check["ok"], (nprobe, k, check)


def test_rerank_sources_and_short_results(tmp_path):
    """The flat sibling wins over the refine codes; without either the ADC
    answers alone; top-k past the corpus pads with id -1 and -inf."""
    asset, ids, vecs = _build_project_store(tmp_path, n=300, dim=32, seed=9)
    assert _index("torch", asset, pq_refine="none").create_index(
        "IndexIVFPQ")
    idx = _index("torch", asset, nprobe=2)
    assert idx.load_index("IndexIVFPQ")
    adc = idx.search_batch(vecs[:2], 8)
    assert idx._ensure_flat_sibling() is None
    scores, got = idx.search_batch(vecs[:2], 400)
    assert scores.shape == got.shape == (2, 400)
    assert np.isneginf(scores).any() and (got[np.isneginf(scores)] == -1).all()
    assert _index("torch", asset).create_index("IndexFlatIP")
    assert idx.load_index("IndexIVFPQ")
    exact = idx.search_batch(vecs[:2], 8)
    assert exact[1][0, 0] == ids[0] and exact[1][1, 0] == ids[1]
    np.testing.assert_allclose(exact[0][:, 0], 1.0, atol=1e-5)
    assert not np.array_equal(adc[0], exact[0])

"""The port's IVF-Flat (wise_tpu_torch/ops/kmeans.py, ops/ivf_paged.py,
index/feature_index.py) against the JAX package.

Tolerances:
- ``kmeans`` from the same seed (both draw their initial centroids and
  re-seeds from ``np.random.default_rng(seed)``): identical assignments,
  centroids within 1e-5 (f32 sums in another order), on clustered data where
  no point sits on a cell boundary.
- ``build_paged_layout`` is a numpy copy: byte-equal.
- ``ivf_search_paged``: identical rows, scores within 1e-5 on unit vectors,
  f32 and bf16 storage, at partial and full nprobe.
- ``.widx`` files: an IVF-Flat file built by either package holds the same
  arrays (ids, cell_offsets equal; centroids within 1e-5) and is searched by
  the other with identical ids.
- IndexIVFPQ through both packages' CLIs: the same result rows, scores as
  printed (3 decimals) within one unit of the last digit.
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
from wise_tpu_torch.config import IndexConfig
from wise_tpu_torch.index.feature_index import FeatureSearchIndex
from wise_tpu_torch.ops import ivf_paged as TP
from wise_tpu_torch.ops import kmeans as TK

FID = "wise/random_features/32/test"


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("WISE_TORCH_DEVICE", "cpu")


def _clustered(seed, n, d, cells):
    rng = np.random.default_rng(seed)
    centers = 3.0 * rng.standard_normal((cells, d)).astype(np.float32)
    x = centers[rng.integers(0, cells, n)] + 0.3 * rng.standard_normal(
        (n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("n,d,k,seed", [
    (2000, 32, 12, 0),
    (200, 16, 60, 1),      # more cells than clusters: empty cells re-seeded
    (10, 8, 16, 2),        # k >= n: every point its own centroid
])
def test_kmeans_matches_reference(n, d, k, seed):
    x = _clustered(seed, n, d, 12)
    want_c, want_a = JK.kmeans(x, k, iters=8, seed=seed)
    got_c, got_a = TK.kmeans(x, k, iters=8, seed=seed)
    np.testing.assert_array_equal(got_a, want_a)
    np.testing.assert_allclose(got_c, want_c, atol=1e-5)
    assert got_c.dtype == np.float32 and got_a.dtype == np.int32


def test_assign_matches_reference():
    x = _clustered(3, 1000, 16, 8)
    cent = x[:20]
    want = np.asarray(JK._assign(jnp.asarray(x), jnp.asarray(cent)))
    np.testing.assert_array_equal(TK.assign_cells(x, cent), want)


def _cell_sorted(seed, n=1500, d=32, nlist=14):
    x = _clustered(seed, n, d, 10)
    cent, assign = JK.kmeans(x, nlist, iters=6, seed=0)
    perm = np.argsort(assign, kind="stable")
    offsets = np.zeros(nlist + 1, np.int64)
    np.cumsum(np.bincount(assign, minlength=nlist), out=offsets[1:])
    return x[perm], cent, offsets


@pytest.mark.parametrize("lpad", [16, 64])
def test_build_paged_layout_byte_equal(lpad):
    xs, _, offsets = _cell_sorted(4)
    want, got = (m.build_paged_layout(xs, offsets, lpad) for m in (JP, TP))
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype
        assert got[name].tobytes() == want[name].tobytes(), name
    assert TP.paged_budget(got["page_count"], 5) == JP.paged_budget(
        want["page_count"], 5)
    assert TP.default_chunk(lpad, 32, 40, nq=3) == JP.default_chunk(
        lpad, 32, 40, nq=3)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("nprobe,chunk,k", [(3, 2, 10), (14, 5, 25),
                                            (14, 1000, 10)])
def test_ivf_search_paged_matches_reference(nprobe, chunk, k, storage):
    xs, cent, offsets = _cell_sorted(5)
    lay = TP.build_paged_layout(xs, offsets, 16)
    budget = TP.paged_budget(lay["page_count"], nprobe)
    chunk = min(chunk, budget)
    q = _clustered(6, 5, 32, 10)
    want_v, want_r = JP.ivf_search_paged(
        jnp.asarray(q), jnp.asarray(cent), jnp.asarray(lay["page_first"]),
        jnp.asarray(lay["page_count"]),
        jnp.asarray(lay["paged"], getattr(jnp, storage)),
        jnp.asarray(lay["page_rows"]), nprobe=nprobe, budget=budget,
        chunk=chunk, k=k)
    t = {name: torch.from_numpy(a) for name, a in lay.items()}
    got_v, got_r = TP.ivf_search_paged(
        torch.from_numpy(q), torch.from_numpy(cent.copy()), t["page_first"],
        t["page_count"], t["paged"].to(getattr(torch, storage)),
        t["page_rows"], nprobe=nprobe, budget=budget, chunk=chunk, k=k)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-5)


def _index(pkg, asset, **cfg):
    if pkg == "jax":
        return JIndex("video", FID, asset, config=JIndexConfig(**cfg))
    return FeatureSearchIndex("video", FID, asset, config=IndexConfig(**cfg))


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
@pytest.mark.parametrize("stream", [False, True])
def test_widx_written_by_one_searched_by_the_other(tmp_path, writer, reader,
                                                   stream):
    asset, ids, vecs = _build_project_store(tmp_path, n=800, dim=32, seed=7)
    cfg = dict(stream_build_threshold_bytes=0 if stream else 1 << 40)
    w = _index(writer, asset, **cfg)
    assert w.create_index("IndexIVFFlat", overwrite=True)
    meta, arrays = read_index_file(w.index_path("IndexIVFFlat"))
    assert meta["index_type"] == "IndexIVFFlat" and meta["count"] == 800
    assert set(arrays) == {"ids", "vectors", "centroids", "cell_offsets"}
    q = np.random.default_rng(2).standard_normal((6, 32)).astype(np.float32)
    out = {}
    for pkg in (writer, reader):
        for nprobe in (4, 10_000):
            idx = _index(pkg, asset, nprobe=nprobe)
            assert idx.load_index("IndexIVFFlat")
            out[pkg, nprobe] = idx.search_batch(q, 10)
    for nprobe in (4, 10_000):
        np.testing.assert_array_equal(out[reader, nprobe][1],
                                      out[writer, nprobe][1])
        np.testing.assert_allclose(out[reader, nprobe][0],
                                   out[writer, nprobe][0], atol=1e-5)
    # full probe is the exact search
    flat = _index("torch", asset)
    assert flat.create_index("IndexFlatIP", overwrite=True)
    assert flat.load_index("IndexFlatIP")
    np.testing.assert_array_equal(out[reader, 10_000][1],
                                  flat.search_batch(q, 10)[1])


@pytest.mark.parametrize("stream", [False, True])
def test_both_packages_build_the_same_file(tmp_path, stream):
    asset, ids, vecs = _build_project_store(tmp_path, n=600, dim=32, seed=4)
    cfg = dict(stream_build_threshold_bytes=0 if stream else 1 << 40)
    files = {}
    for pkg in ("jax", "torch"):
        idx = _index(pkg, asset, **cfg)
        assert idx.create_index("IndexIVFFlat", overwrite=True)
        files[pkg] = read_index_file(idx.index_path("IndexIVFFlat"),
                                     mmap_arrays=False)
    (jm, ja), (tm, ta) = files["jax"], files["torch"]
    assert tm == jm
    for name in ("ids", "cell_offsets", "vectors"):
        np.testing.assert_array_equal(ta[name], ja[name], err_msg=name)
    np.testing.assert_allclose(ta["centroids"], ja["centroids"], atol=1e-5)


def test_ivf_pads_short_results_and_warns_on_int8(tmp_path, caplog):
    asset, ids, vecs = _build_project_store(tmp_path, n=60, dim=32, seed=9)
    idx = _index("torch", asset, nprobe=1, storage_dtype="int8")
    assert idx.create_index("IndexIVFFlat", overwrite=True)
    assert idx.load_index("IndexIVFFlat")
    with caplog.at_level("WARNING"):
        scores, got = idx.search_batch(vecs[:2], 50)
    assert scores.shape == got.shape == (2, 50)
    assert (got[np.isneginf(scores)] == -1).all()
    assert np.isneginf(scores).any() and got[0, 0] == ids[0]
    assert any("int8 only applies" in r.message for r in caplog.records)


def test_unsupported_index_type_raises(tmp_path):
    asset, _, _ = _build_project_store(tmp_path, n=40, dim=32, seed=1)
    with pytest.raises(ValueError, match="unsupported"):
        _index("torch", asset).create_index("IndexHNSW")


@pytest.mark.parametrize("rerank", ["flat", "refine"])
def test_ivfpq_cli_build_and_search_match_jax(tmp_path, rerank):
    """IndexIVFPQ through each package's create-index and search CLIs on one
    project (a copy each): the same result rows (file, times, ids' order),
    with the flat-sibling rerank and, without the flat file, the int8
    refine rerank."""
    import csv
    import importlib
    import shutil

    from tests.media_fixtures import make_video

    media = tmp_path / "media"
    media.mkdir()
    for i in range(3):
        make_video(media / f"v{i}.mp4", seconds=8, fps=10)
    fid = "wise/random_features/32/ivfpq"
    seed = tmp_path / "seed"
    assert importlib.import_module(
        "wise_tpu_torch.cli.extract_features").main([
            str(media), "--project-dir", str(seed), "--video-feature-id", fid,
            "--image-feature-id", fid, "--audio-feature-id", fid]) == 0
    rows = {}
    for pkg in ("wise_tpu", "wise_tpu_torch"):
        proj = tmp_path / pkg
        shutil.copytree(seed, proj)
        cli = {name: importlib.import_module(f"{pkg}.cli.{name}").main
               for name in ("create_index", "search")}
        types = ["IndexIVFPQ"] + (["IndexFlatIP"] if rerank == "flat" else [])
        for index_type in types:
            assert cli["create_index"]([
                "--project-dir", str(proj), "--index-type", index_type,
                "--media-type", "video"]) == 0
        out = tmp_path / f"{pkg}.csv"
        assert cli["search"]([
            "--project-dir", str(proj), "--query", "skiing", "--in",
            "video", "--topk", "10", "--no-merge", "--result-format", "csv",
            "--save-to-file", str(out), "--index-type", "IndexIVFPQ"]) == 0
        with open(out) as f:
            rows[pkg] = list(csv.reader(f))
    got, want = rows["wise_tpu_torch"], rows["wise_tpu"]
    assert len(got) == len(want) == 11
    assert [r[:-1] for r in got] == [r[:-1] for r in want]
    for g, w in zip(got[1:], want[1:]):
        assert abs(float(g[-1]) - float(w[-1])) <= 1.001e-3

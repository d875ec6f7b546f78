"""The port's FeatureSearchIndex on a mesh (index/feature_index.py, its
sharded arms) against the port on one device and the JAX package's
FeatureSearchIndex, which on the 8 CPU devices of tests/conftest.py runs its
own sharded arms.

The port's mesh is ``WISE_TORCH_DEVICE=cpu,cpu,cpu,cpu``: four shards. The
project holds 2,500 vectors and the port's flat group is cut from 4,096 to
1,024 rows for the test (``FeatureSearchIndex.GROUP``), so that the flat
rows (shards of dp x GROUP rows) fill two shards, part of a third and none
of the fourth, as a collection a little larger than a card does. The three
index types are built once by the port on one device; both packages read
the same files.

Tolerances:
- IndexFlatIP f32 and int8 (the int8 candidates reranked in f32 on the
  host): the same ids, scores within 1e-5;
- bf16 storage, IVF-Flat and IVF-PQ: ``ops.fused_topk.topk_agreement`` at
  1e-5 (scores position by position, ids equal except swaps between scores
  within 1e-5), as tests/test_torch_ivf.py and tests/test_torch_pq.py hold
  the single-device paths.
"""

import numpy as np
import pytest
import torch

import jax

from tests.test_index import _build_project_store
from wise_tpu.config import IndexConfig as JIndexConfig
from wise_tpu.index import FeatureSearchIndex as JIndex
from wise_tpu_torch.config import IndexConfig
from wise_tpu_torch.index.feature_index import FeatureSearchIndex
from wise_tpu_torch.ops.fused_topk import topk_agreement

FID = "wise/random_features/32/test"
N = 2500
GROUP = 1024
TOL = 1e-5
MESH = "cpu,cpu,cpu,cpu"
#: the build's settings; the searches take the package's defaults but these
BUILD = dict(pq_train_samples=2000, pq_opq_iters=2)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """A store of N unit vectors with the three index files beside it, and
    eight queries: four stored vectors, four random."""
    tmp = tmp_path_factory.mktemp("sharded_index")
    asset, ids, vecs = _build_project_store(tmp, n=N, dim=32, seed=11)
    builder = FeatureSearchIndex("video", FID, asset,
                                 config=IndexConfig(**BUILD), device="cpu")
    for kind in ("IndexFlatIP", "IndexIVFFlat", "IndexIVFPQ"):
        assert builder.create_index(kind, overwrite=True)
    rng = np.random.default_rng(4)
    q = np.concatenate([vecs[[3, 1100, 2100, 2499]],
                        rng.standard_normal((4, 32)).astype(np.float32)])
    return asset, ids, np.ascontiguousarray(q, np.float32)


def _search(pkg, asset, kind, q, k, monkeypatch, **cfg):
    if pkg == "jax":
        assert jax.device_count() == 8
        idx = JIndex("video", FID, asset, config=JIndexConfig(**cfg))
    else:
        monkeypatch.setenv("WISE_TORCH_DEVICE",
                           MESH if pkg == "mesh" else "cpu")
        monkeypatch.setattr(FeatureSearchIndex, "GROUP", GROUP)
        idx = FeatureSearchIndex("video", FID, asset,
                                 config=IndexConfig(**cfg))
        assert idx._mesh.shape == {"dp": 4 if pkg == "mesh" else 1}
        assert idx._sharded == (pkg == "mesh")
    assert idx.load_index(kind)
    return idx, idx.search_batch(q, k)


def _rows(result, ids):
    """(scores, ids) -> tensors of the scores and each id's position in
    ``ids`` (-1 for an empty slot), which topk_agreement compares."""
    scores, got = result
    order = np.argsort(ids)
    rows = order[np.searchsorted(ids[order], got)]
    rows[got < 0] = -1
    return torch.from_numpy(np.array(scores)), torch.from_numpy(rows)


def _agree(got, want, ids):
    check = topk_agreement(_rows(got, ids), _rows(want, ids), tol=TOL)
    assert check["ok"], check


@pytest.mark.parametrize("storage", ["float32", "int8"])
@pytest.mark.parametrize("k", [10, 100])
def test_flat_on_a_mesh(project, monkeypatch, storage, k):
    asset, ids, q = project
    out = {pkg: _search(pkg, asset, "IndexFlatIP", q, k, monkeypatch,
                        storage_dtype=storage)
           for pkg in ("mesh", "one", "jax")}
    idx, got = out["mesh"]
    shards = (idx._int8_shards[0] if storage == "int8" else idx._sharded_db)
    assert [s.shape[0] for s in shards] == [GROUP] * 4
    for pkg in ("one", "jax"):
        want = out[pkg][1]
        np.testing.assert_array_equal(got[1], want[1], err_msg=pkg)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TOL)
    assert got[1].shape == (len(q), k) and (got[1] > 0).all()


def test_flat_bf16_on_a_mesh(project, monkeypatch):
    asset, ids, q = project
    out = {pkg: _search(pkg, asset, "IndexFlatIP", q, 20, monkeypatch,
                        storage_dtype="bfloat16")[1]
           for pkg in ("mesh", "one", "jax")}
    _agree(out["mesh"], out["one"], ids)
    _agree(out["mesh"], out["jax"], ids)


def test_the_exact_sharded_scan_wins_over_the_approximate(project,
                                                          monkeypatch):
    """With a mesh, ``flat_approx_recall`` does not apply (the reference's
    precedence): the exact sharded result, through the serving coalescer's
    dispatch and finalize too."""
    asset, ids, q = project
    idx, got = _search("mesh", asset, "IndexFlatIP", q, 10, monkeypatch,
                       flat_approx_recall=0.5)
    _, exact = _search("one", asset, "IndexFlatIP", q, 10, monkeypatch)
    np.testing.assert_array_equal(got[1], exact[1])
    handle = idx.search_batch_dispatch(q, 10)
    assert isinstance(handle[0], np.ndarray)
    for i in range(len(q)):
        scores, row_ids = idx.search_batch_finalize(handle, i)
        np.testing.assert_array_equal(row_ids, exact[1][i])
        np.testing.assert_allclose(scores, exact[0][i], rtol=0, atol=TOL)


@pytest.mark.parametrize("nprobe", [8, 10_000])
def test_ivf_flat_on_a_mesh(project, monkeypatch, nprobe):
    asset, ids, q = project
    out = {pkg: _search(pkg, asset, "IndexIVFFlat", q, 10, monkeypatch,
                        nprobe=nprobe)
           for pkg in ("mesh", "one", "jax")}
    idx, got = out["mesh"]
    pg = idx._ivf_paged
    assert len(pg["paged"]) == 4 and pg["page_count_host"].any(axis=1).all()
    _agree(got, out["one"][1], ids)
    _agree(got, out["jax"][1], ids)


@pytest.mark.parametrize("rerank", [True, False])
def test_ivfpq_on_a_mesh(project, monkeypatch, rerank):
    asset, ids, q = project
    out = {pkg: _search(pkg, asset, "IndexIVFPQ", q, 10, monkeypatch,
                        nprobe=16, pq_exact_rerank=rerank)[1]
           for pkg in ("mesh", "one", "jax")}
    _agree(out["mesh"], out["one"], ids)
    _agree(out["mesh"], out["jax"], ids)

"""IVF-PQ's paged ADC (wise_tpu_torch/ops/ivf_paged.py ``ivfpq_search_paged``)
on the card against the same call on CPU tensors, and the index's resident
device copy.

Every test here needs a CUDA device, carries the ``cuda`` marker and skips
without one. The file imports no JAX, so it also runs on a GPU machine
without it:

    python -m pytest --noconftest tests/test_torch_pq_cuda.py -q

Tolerance (``ops.fused_topk.topk_agreement``): scores within 1e-5 position
by position, rows equal except swaps between scores within 1e-5 (the probe
product and the ADC tables are f32 sums in cuBLAS's order on the card).
"""

import numpy as np
import pytest
import torch

from wise_tpu_torch.ops import ivf_paged as TP
from wise_tpu_torch.ops import pq as TQ
from wise_tpu_torch.ops.fused_topk import topk_agreement
from wise_tpu_torch.ops.kmeans import kmeans


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _layout(n=20000, d=128, nlist=64, m=8, lpad=128):
    """Cell-sorted OPQ codes of n unit vectors, paged; centroids rotated."""
    rng = np.random.default_rng(0)
    x = _unit(rng, n, d)
    cent, assign = kmeans(x, nlist, iters=5, seed=0, device="cpu")
    perm = np.argsort(assign, kind="stable")
    offsets = np.zeros(nlist + 1, np.int64)
    np.cumsum(np.bincount(assign, minlength=nlist), out=offsets[1:])
    resid = (x - cent[assign])[perm]
    rot, books = TQ.train_opq(resid, m, 256, iters=4, opq_iters=2,
                              device="cpu")
    codes = TQ.encode_pq(resid @ rot, books)
    return (TP.build_paged_layout(codes, offsets, lpad),
            (cent @ rot).astype(np.float32), books, rot, _unit(rng, 64, d))


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nprobe,k", [(1, 16, 10), (8, 64, 40),
                                         (64, 32, 100)])
def test_ivfpq_search_paged_card_matches_cpu(cuda, nq, nprobe, k):
    lay, cent, books, rot, q = _layout()
    q = (q[:nq] @ rot).astype(np.float32)
    budget = TP.paged_budget(lay["page_count"], nprobe)
    chunk = TP.default_chunk(128, 256, budget, nq=nq)
    out = {}
    for dev in ("cpu", cuda):
        t = {name: torch.from_numpy(a).to(dev) for name, a in lay.items()}
        v, r = TP.ivfpq_search_paged(
            torch.from_numpy(q).to(dev), torch.from_numpy(cent).to(dev),
            t["page_first"], t["page_count"], t["paged"], t["page_rows"],
            torch.from_numpy(books).to(dev), nprobe=nprobe, budget=budget,
            chunk=chunk, k=k)
        assert v.device.type == torch.device(dev).type
        out[str(dev)] = (v.cpu(), r.cpu())
    check = topk_agreement(out["cuda"], out["cpu"], tol=1e-5)
    assert check["ok"], check
    assert not torch.isinf(out["cuda"][0]).any()


@pytest.mark.cuda
def test_ivfpq_index_keeps_codes_and_books_on_the_card(cuda, tmp_path):
    """An IVF-PQ index built and searched on the card: uint8 paged codes and
    f32 codebooks resident there; the ADC's candidates equal the host ADC's
    up to near-ties."""
    from wise_tpu_torch.config import IndexConfig
    from wise_tpu_torch.index.feature_index import FeatureSearchIndex
    from wise_tpu_torch.store.tar_store import TarShardStore

    rng = np.random.default_rng(3)
    vecs = _unit(rng, 3000, 64)
    fdir = tmp_path / "features"
    fdir.mkdir()
    store = TarShardStore("video", fdir)
    store.enable_write(shard_maxcount=1024, shard_maxsize=1 << 24)
    for i, v in enumerate(vecs):
        store.add(i + 1, v[None])
    store.close()
    asset = {"features_dir": str(fdir), "index_dir": str(tmp_path / "index")}
    cfg = IndexConfig(pq_train_samples=3000, nprobe=16,
                      pq_exact_rerank=False)
    idx = FeatureSearchIndex("video", "wise/random_features/64/pq", asset,
                             config=cfg, device=cuda)
    assert idx.create_index("IndexIVFPQ")
    assert idx.load_index("IndexIVFPQ")
    q = vecs[:8]
    got = idx._search_ivfpq_device(q, 10, 16)
    pg = idx._ensure_pq_paged()
    (paged,), (codebooks,), (page_rows,) = (
        pg["paged"], pg["codebooks"], pg["page_rows"])   # one shard
    assert paged.dtype == torch.uint8 and paged.is_cuda
    assert codebooks.dtype == torch.float32 and codebooks.is_cuda
    assert page_rows.is_cuda
    want = idx._search_ivfpq_host(q, 10, 16)
    check = topk_agreement(tuple(map(torch.from_numpy, got)),
                           tuple(map(torch.from_numpy, want)), tol=1e-5)
    assert check["ok"], check

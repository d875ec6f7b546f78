"""The port's sharded search (wise_tpu_torch/parallel/sharded_search.py,
ops/ivf_paged.py ``shard_paged_layout``) against the JAX package's on the
8 CPU devices that tests/conftest.py forces, and against the port's own
single-device search.

The port's mesh here is 8 or 4 ``cpu`` devices (parallel/mesh.py): each
shard runs the port's single-device ops (``flat_topk``, ``int8_candidates``,
``paged_*_core``) on its rows in their plain versions, and the candidates
are merged by (score descending, row ascending). The flat shards are a
multiple of ``group`` rows; a small group spreads a small database over
every shard, as the reference's padding to a multiple of dp does.

Tolerances:
- the flat scan: identical rows, scores within 1e-5 (f32 sums in another
  order), on random vectors and on integer vectors with planted ties (every
  score exact, ties to the lower global row on both sides);
- int8 candidates: identical rows and scores (the same integer sums and the
  same rescale);
- ``shard_paged_layout`` is a numpy copy: array-equal;
- IVF-Flat and IVF-PQ: ``ops.fused_topk.topk_agreement`` at 1e-5 (scores
  position by position; rows equal except swaps between scores within
  1e-5), as tests/test_torch_ivf.py and tests/test_torch_pq.py hold the
  single-device cores.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from wise_tpu.ops import ivf_paged as JP
from wise_tpu.ops import kmeans as JK
from wise_tpu.ops import pq as JQ
from wise_tpu.ops.topk import numpy_reference_topk, quantize_rows_int8
from wise_tpu.parallel import mesh as JM
from wise_tpu.parallel import sharded_search as JS
from wise_tpu_torch.ops import ivf_paged as TP
from wise_tpu_torch.ops.fused_topk import topk_agreement
from wise_tpu_torch.ops.topk import flat_topk, pad_rows
from wise_tpu_torch.parallel import mesh as TM
from wise_tpu_torch.parallel import sharded_search as TS

TOL = 1e-5


def _meshes(ndev):
    """(the JAX package's mesh, the port's) of ``ndev`` CPU devices."""
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return (JM.get_mesh(dp=ndev, devices=jax.devices()[:ndev]),
            TM.get_mesh(dp=ndev, devices=["cpu"] * ndev))


def _agree(got, want, tol=TOL):
    check = topk_agreement(tuple(torch.from_numpy(np.array(a))
                                 for a in got),
                           tuple(torch.from_numpy(np.array(a))
                                 for a in want), tol=tol)
    assert check["ok"], check


@pytest.mark.parametrize("ndev", [8, 4])
@pytest.mark.parametrize("n,d,q,k,group", [(1000, 64, 3, 10, 64),
                                           (777, 32, 2, 5, 32),
                                           (64, 16, 1, 8, 8),
                                           (300, 16, 4, 40, 16)])
def test_sharded_scan_matches_reference(ndev, n, d, q, k, group):
    jmesh, tmesh = _meshes(ndev)
    rng = np.random.default_rng(n + ndev)
    db = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)

    shards, n_total = TS.pad_and_shard_db(tmesh, db, group=group)
    assert len(shards) == ndev and n_total == n
    assert all(s.shape[0] % group == 0 for s in shards)
    vals, rows = TS.sharded_scan_topk(tmesh, queries, shards, n_total, k,
                                      group=group)
    j_db, _ = JS.pad_and_shard_db(jmesh, db)
    want_v, want_r = JS.sharded_scan_topk(jmesh, queries, j_db, n, k)
    ref_v, ref_r = numpy_reference_topk(queries, db, k)
    np.testing.assert_array_equal(rows, want_r)
    np.testing.assert_array_equal(rows, ref_r)
    np.testing.assert_allclose(vals, want_v, rtol=0, atol=TOL)
    np.testing.assert_allclose(vals, ref_v, rtol=0, atol=TOL)


@pytest.mark.parametrize("ndev", [8, 4])
def test_sharded_scan_breaks_ties_to_the_lower_row(ndev):
    """Integer vectors, every score exact and many tied across shards: the
    reference's order, the numpy reference's, and the single device's."""
    jmesh, tmesh = _meshes(ndev)
    rng = np.random.default_rng(3)
    db = rng.integers(-2, 3, (500, 16)).astype(np.float32)
    queries = rng.integers(-2, 3, (3, 16)).astype(np.float32)
    shards, n = TS.pad_and_shard_db(tmesh, db, group=16)
    vals, rows = TS.sharded_scan_topk(tmesh, queries, shards, n, 30,
                                      group=16)
    j_db, _ = JS.pad_and_shard_db(jmesh, db)
    want_v, want_r = JS.sharded_scan_topk(jmesh, queries, j_db, n, 30)
    one = flat_topk(torch.from_numpy(queries),
                    pad_rows(torch.from_numpy(db), 16), n, 30, group=16)
    ref_v, ref_r = numpy_reference_topk(queries, db, 30)
    assert (np.diff(ref_v, axis=1) == 0).any(), "no tie planted"
    for r in (want_r, ref_r, one[1].numpy()):
        np.testing.assert_array_equal(rows, r)
    np.testing.assert_array_equal(vals, ref_v)


def test_sharded_tiny_db_with_padding():
    """2 rows over 8 shards at k 5, every score negative: the zero rows of
    the padding and the six all-padding shards must not contribute."""
    jmesh, tmesh = _meshes(8)
    rng = np.random.default_rng(0)
    db = -np.abs(rng.standard_normal((2, 16))).astype(np.float32)
    q = np.ones((1, 16), dtype=np.float32)
    shards, n = TS.pad_and_shard_db(tmesh, db)
    assert n == 2 and shards[0].shape == (TS.GROUP, 16)
    vals, rows = TS.sharded_scan_topk(tmesh, q, shards, n, 5)
    j_db, _ = JS.pad_and_shard_db(jmesh, np.asarray(pad_rows(
        torch.from_numpy(db), 4096)))
    want_v, want_r = JS.sharded_scan_topk(jmesh, q, j_db, 2, 5)
    ref_v, ref_r = numpy_reference_topk(q, db, 2)
    assert rows.shape == (1, 2) and np.isfinite(vals).all()
    np.testing.assert_array_equal(rows, ref_r)
    np.testing.assert_array_equal(rows, np.asarray(want_r))
    np.testing.assert_allclose(vals, ref_v, rtol=0, atol=TOL)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_sharded_scan_equals_the_single_device(storage):
    """Shards of a tensor are views of it; bf16 shards score as the single
    device's bf16 scan (bf16 query, f32 sums)."""
    _, tmesh = _meshes(4)
    rng = np.random.default_rng(9)
    dtype = getattr(torch, storage)
    db = torch.from_numpy(rng.standard_normal((900, 32)).astype(np.float32))
    q = rng.standard_normal((5, 32)).astype(np.float32)
    shards, n = TS.pad_and_shard_db(tmesh, db, group=64)
    assert shards[0].data_ptr() == db.data_ptr()
    shards = [s.to(dtype) for s in shards]
    vals, rows = TS.sharded_scan_topk(tmesh, q, shards, n, 12, group=64)
    want = flat_topk(torch.from_numpy(q), pad_rows(db, 64).to(dtype), n, 12,
                     group=64)
    _agree((vals, rows), want)


@pytest.mark.parametrize("ndev", [8, 4])
@pytest.mark.parametrize("n,kc", [(1000, 40), (90, 120)])
def test_sharded_int8_candidates_match_reference(ndev, n, kc):
    jmesh, tmesh = _meshes(ndev)
    rng = np.random.default_rng(n)
    db = rng.standard_normal((n, 32)).astype(np.float32)
    q = rng.standard_normal((3, 32)).astype(np.float32)
    codes, scales = quantize_rows_int8(db)
    j_codes, _ = JS.pad_and_shard_db(jmesh, codes)
    j_scales = jax.device_put(
        np.pad(scales, (0, j_codes.shape[0] - n)),
        NamedSharding(jmesh, P("dp")))
    want_v, want_r = JS.sharded_int8_candidates(jmesh, q, j_codes, j_scales,
                                                n, kc)
    t_codes, _ = TS.pad_and_shard_db(tmesh, codes, group=16)
    n_pad = ndev * t_codes[0].shape[0]
    t_scales = TM.shard_rows(tmesh, np.pad(scales, (0, n_pad - n)))
    vals, rows = TS.sharded_int8_candidates(tmesh, q, t_codes, t_scales, n,
                                            kc, group=16)
    assert rows.shape == (3, min(kc, n))
    np.testing.assert_array_equal(rows, np.asarray(want_r))
    np.testing.assert_array_equal(vals, np.asarray(want_v))


@pytest.mark.parametrize("counts,ndev", [
    ([1, 3], 2),                 # the boundary cell goes right
    ([5, 1, 1, 1, 4, 2, 2], 3),
    ([2, 0, 3, 1], 8),           # more devices than cells
    ([0, 0, 7], 4),
])
def test_shard_paged_layout_equals_reference(counts, ndev):
    lpad, w = 4, 3
    rows = np.array(counts) * lpad - np.minimum(np.array(counts), 1)
    offsets = np.concatenate([[0], np.cumsum(rows)]).astype(np.int64)
    data = np.arange(offsets[-1] * w, dtype=np.float32).reshape(-1, w)
    lay = JP.build_paged_layout(data, offsets, lpad)
    want = JP.shard_paged_layout(lay, ndev)
    got = TP.shard_paged_layout(TP.build_paged_layout(data, offsets, lpad),
                                ndev)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _clustered(seed, n, d, cells):
    rng = np.random.default_rng(seed)
    centers = 3.0 * rng.standard_normal((cells, d)).astype(np.float32)
    x = centers[rng.integers(0, cells, n)] + 0.3 * rng.standard_normal(
        (n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _cells(seed, n=1500, d=32, nlist=14):
    x = _clustered(seed, n, d, 10)
    cent, assign = JK.kmeans(x, nlist, iters=6, seed=0)
    perm = np.argsort(assign, kind="stable")
    offsets = np.zeros(nlist + 1, np.int64)
    np.cumsum(np.bincount(assign, minlength=nlist), out=offsets[1:])
    return x, assign, perm, cent, offsets


@pytest.mark.parametrize("ndev,nprobe,k", [(8, 3, 10), (4, 14, 25)])
def test_sharded_ivf_matches_reference(ndev, nprobe, k):
    jmesh, tmesh = _meshes(ndev)
    x, _, perm, cent, offsets = _cells(4)
    data = x[perm]
    q = _clustered(6, 7, 32, 10)
    j_pg = JS.build_sharded_paged(jmesh, data, offsets, 16)
    budget, chunk = JS.sharded_paged_plan(j_pg, nprobe, 32, nq=7)
    want = JS.sharded_ivf_paged_topk(jmesh, q, jnp.asarray(cent), j_pg,
                                     nprobe, k, chunk, budget)
    pg = TS.build_sharded_paged(tmesh, data, offsets, 16)
    assert (budget, chunk) == TS.sharded_paged_plan(pg, nprobe, 32, nq=7)
    got = TS.sharded_ivf_paged_topk(tmesh, q, torch.tensor(cent), pg,
                                    nprobe, k, chunk, budget)
    _agree(got, want)
    lay = {name: torch.from_numpy(a) for name, a in
           TP.build_paged_layout(data, offsets, 16).items()}
    one_budget = TP.paged_budget(lay["page_count"].numpy(), nprobe)
    one = TP.paged_flat_core(
        torch.from_numpy(q), torch.tensor(cent), lay["page_first"],
        lay["page_count"], lay["paged"], lay["page_rows"], nprobe=nprobe,
        budget=one_budget, chunk=3, k=k)
    _agree(got, one)


@pytest.mark.parametrize("ndev,nprobe,k", [(8, 3, 10), (4, 14, 25)])
def test_sharded_ivfpq_matches_reference(ndev, nprobe, k):
    jmesh, tmesh = _meshes(ndev)
    x, assign, perm, cent, offsets = _cells(5, d=64)
    books = JQ.train_pq((x - cent[assign])[perm], 8, 64, iters=4)
    codes = JQ.encode_pq((x - cent[assign])[perm], books)
    q = _clustered(6, 7, 64, 10)
    j_pg = JS.build_sharded_paged(jmesh, codes, offsets, 16)
    budget, chunk = JS.sharded_paged_plan(j_pg, nprobe, 256, nq=7)
    want = JS.sharded_ivfpq_paged_topk(jmesh, q, jnp.asarray(cent), j_pg,
                                       jnp.asarray(books), nprobe, k, chunk,
                                       budget)
    pg = TS.build_sharded_paged(tmesh, codes, offsets, 16)
    assert pg["paged"][0].dtype == torch.uint8
    got = TS.sharded_ivfpq_paged_topk(
        tmesh, q, TM.replicate(tmesh, np.array(cent)), pg,
        torch.tensor(books),
        nprobe, k, chunk, budget)
    _agree(got, want)
    lay = {name: torch.from_numpy(a) for name, a in
           TP.build_paged_layout(codes, offsets, 16).items()}
    one = TP.paged_pq_core(
        torch.from_numpy(q), torch.tensor(cent), lay["page_first"],
        lay["page_count"], lay["paged"], lay["page_rows"],
        torch.from_numpy(books), nprobe=nprobe,
        budget=TP.paged_budget(lay["page_count"].numpy(), nprobe), chunk=4,
        k=k)
    _agree(got, one)


def test_mesh_matches_reference():
    """The 'dp' axis of the reference's mesh: its first dp devices, all of
    them with dp -1 (the port leaves out the 'mp' axis until tensor
    parallelism uses it)."""
    jmesh = JM.get_mesh(dp=4, devices=jax.devices()[:4])
    tmesh = TM.get_mesh(dp=4, devices=["cpu"] * 8)
    assert tmesh.shape["dp"] == jmesh.shape["dp"] == 4
    assert tmesh.devices == [torch.device("cpu")] * 4
    assert TM.get_mesh(devices=["cpu"] * 3).shape == {"dp": 3}
    with pytest.raises(ValueError, match="needs 16 devices"):
        TM.get_mesh(dp=16, devices=["cpu"] * 8)
    parts = TM.shard_rows(tmesh, np.arange(12.0).reshape(4, 3))
    assert [p.tolist() for p in parts] == np.arange(12.0).reshape(
        4, 1, 3).tolist()
    with pytest.raises(ValueError, match="does not divide"):
        TM.shard_rows(tmesh, np.zeros((6, 2)))


@pytest.mark.parametrize("asked,want", [
    ("cpu,cpu,cpu,cpu", ["cpu"] * 4),
    ("cuda:0,cuda:0", ["cuda:0", "cuda:0"]),
    ("cuda:1, cuda:0", ["cuda:1", "cuda:0"]),
    ("cuda,cuda:1", ["cuda:0", "cuda:1"]),
])
def test_device_lists_name_the_mesh(monkeypatch, asked, want):
    """``WISE_TORCH_DEVICE`` as a list: the mesh's devices in order (a card
    may be named twice), ``default_device()`` the first, and the mesh the
    index and ``get_mesh`` build from it. Two cards are faked."""
    from wise_tpu_torch.utils import device as D

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("WISE_TORCH_DEVICE", asked)
    assert D.default_devices() == [torch.device(w) for w in want]
    assert D.default_device() == torch.device(want[0])
    assert D.named_devices() == [torch.device(w) for w in want]
    mesh = TM.get_mesh()
    assert mesh.shape == {"dp": len(want)}
    assert mesh.devices == [torch.device(w) for w in want]


@pytest.mark.parametrize("asked,error,match", [
    ("cuda:0,cuda:2", RuntimeError, r"no card \[2\]"),
    ("cuda:3,cuda:3", RuntimeError, r"no card \[3\]"),
    ("cpu,cuda:0", ValueError, "one device type"),
    ("cpu,tpu", (RuntimeError, ValueError), "tpu"),
])
def test_device_lists_refuse_what_the_machine_lacks(monkeypatch, asked,
                                                     error, match):
    from wise_tpu_torch.utils import device as D

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("WISE_TORCH_DEVICE", asked)
    for fn in (D.default_devices, D.default_device, D.named_devices):
        with pytest.raises(error, match=match):
            fn()


def test_a_card_list_without_a_card_raises(monkeypatch):
    from wise_tpu_torch.utils import device as D

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("WISE_TORCH_DEVICE", "cuda:0,cuda:0")
    with pytest.raises(RuntimeError, match="is_available"):
        D.default_devices()
    monkeypatch.delenv("WISE_TORCH_DEVICE")
    with pytest.raises(RuntimeError, match="WISE_TORCH_DEVICE=cpu"):
        D.default_devices()


def test_only_a_named_list_shards_an_index(monkeypatch):
    """On a machine of four cards, the mesh's default is every card, but an
    index searches on the first alone unless ``WISE_TORCH_DEVICE`` names a
    list; one named device is a list of one."""
    from wise_tpu_torch.utils import device as D

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("WISE_TORCH_DEVICE", raising=False)
    assert D.default_devices() == [torch.device("cuda", i) for i in range(4)]
    assert D.named_devices() == [torch.device("cuda")]
    monkeypatch.setenv("WISE_TORCH_DEVICE", "cuda:2")
    assert D.named_devices() == [torch.device("cuda:2")]
    monkeypatch.setenv("WISE_TORCH_DEVICE", "cuda:2,cuda:3")
    assert D.named_devices() == [torch.device("cuda:2"),
                                 torch.device("cuda:3")]

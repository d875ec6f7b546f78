"""Multi-device sharded inner-product top-k
(wise_tpu/parallel/sharded_search.py).

The database rows are split over the mesh's 'dp' devices, one shard a
device (parallel/mesh.py; a device may hold several shards). Each shard runs
the port's single-device search on its rows, then the per-shard top-k
candidates are copied to the first device and merged there, the counterpart
of the reference's all-gather of (ndev, Q, k) candidates.

- The flat scan goes through ``ops.topk.flat_topk``: on a card the port's
  kernels, ``fused_topk_threshold`` for a served query and ``fused_topk`` for
  a batch (``routes_to_threshold``); on the CPU their plain versions. The
  reference's shard body calls XLA's ``top_k``; the kernels are the port's
  single-device path, used here shard by shard.
- The int8 candidates go through ``ops.topk.int8_candidates``, IVF-Flat and
  IVF-PQ through ``ops.ivf_paged.paged_flat_core`` / ``paged_pq_core`` over
  each device's contiguous cell range (``shard_paged_layout``).

The process is one, as the reference's single controller is: every shard is
launched before any result is read, so that shards on several cards run at
once. The merge orders candidates by (score descending, row ascending)
through ``ops.fused_topk.order_key``: shards hold ascending global row
ranges, so ties go to the lowest global row, the faiss order that the
reference's device-major ``top_k`` gives.

A flat shard is a whole number of ``group`` rows, because the kernels take
whole groups: the rows pad to a multiple of dp x group (the reference pads
to a multiple of dp), and global row = shard x shard_rows + local row. A
shard whose rows are all padding contributes nothing.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.fused_topk import order_key
from ..ops.topk import flat_topk, int8_candidates
from .mesh import Mesh, replicate

#: rows of a group of the flat kernels (index/feature_index.py GROUP)
GROUP = 4096


def _host(x) -> np.ndarray:
    return x.cpu().numpy()


def _queries(mesh: Mesh, queries) -> list:
    """The f32 queries on every 'dp' device (one copy a distinct device)."""
    q = torch.as_tensor(np.ascontiguousarray(queries, dtype=np.float32)
                        if not isinstance(queries, torch.Tensor)
                        else queries.float())
    return replicate(mesh, q)


def _per_shard(mesh: Mesh, x) -> list:
    """A replicated argument: a list from ``mesh.replicate`` as it is, or
    one array copied to every 'dp' device."""
    return list(x) if isinstance(x, (list, tuple)) else replicate(mesh, x)


def _local_valid(n_total: int, shard: int, shard_rows: int) -> int:
    return min(shard_rows, n_total - shard * shard_rows)


def _merge_gathered_topk(vals, idx, k: int):
    """Per-shard (Q, k_i) candidates -> the global top-k on the first
    shard's device, ordered by (score descending, global row ascending)."""
    dev = vals[0].device
    s = torch.cat([v.to(dev) for v in vals], dim=1)
    r = torch.cat([i.to(dev).long() for i in idx], dim=1)
    _, pos = torch.topk(order_key(s, r), min(k, s.shape[1]), dim=1)
    return torch.gather(s, 1, pos), torch.gather(r, 1, pos)


def pad_and_shard_db(mesh: Mesh, db, group: int = GROUP):
    """Pad rows to a multiple of dp x ``group`` and place shard i (rows i *
    shard_rows onward) on the i-th 'dp' device. ``db`` is host (numpy, a
    memmap) or a tensor; a tensor's shards on its own device are views.
    Returns (list of (shard_rows, D) shards, n_total)."""
    ndev = mesh.shape["dp"]
    n = int(db.shape[0])
    shard_rows = max(1, -(-n // (ndev * group))) * group
    src = db if isinstance(db, torch.Tensor) else None
    shards = []
    for i, dev in enumerate(mesh.devices):
        lo, hi = min(n, i * shard_rows), min(n, (i + 1) * shard_rows)
        rows = (src[lo:hi] if src is not None
                else torch.from_numpy(np.ascontiguousarray(db[lo:hi])))
        rows = rows.to(dev)
        if hi - lo < shard_rows:
            rows = torch.cat([rows, rows.new_zeros(
                (shard_rows - (hi - lo), rows.shape[1]))])
        shards.append(rows)
    return shards, n


def _flat_candidates(mesh, queries, db_sharded, n_total: int, k: int,
                     group: int):
    """Every non-empty shard's flat top-k, launched in shard order, with
    global rows; nothing read back."""
    shard_rows = db_sharded[0].shape[0]
    qs = _queries(mesh, queries)
    vals, idx = [], []
    for i, shard in enumerate(db_sharded):
        valid = _local_valid(n_total, i, shard_rows)
        if valid <= 0:
            continue
        v, r = flat_topk(qs[i], shard, n_valid=valid, k=min(k, valid),
                         group=group)
        vals.append(v)
        idx.append(r + i * shard_rows)
    return vals, idx


def sharded_scan_topk(
    mesh: Mesh,
    queries,
    db_sharded,
    n_total: int,
    k: int,
    group: int = GROUP,
) -> Tuple[np.ndarray, np.ndarray]:
    """queries (Q, D) on the host; db_sharded from ``pad_and_shard_db``
    (rows >= n_total are padding). Returns host numpy (scores (Q, k'),
    global rows (Q, k')), k' = min(k, n_total)."""
    k_eff = min(int(k), int(n_total))
    vals, idx = _merge_gathered_topk(
        *_flat_candidates(mesh, queries, db_sharded, int(n_total), k_eff,
                          group), k_eff)
    return _host(vals), _host(idx)


def sharded_int8_candidates(mesh: Mesh, queries, codes_sharded,
                            scales_sharded, n_total: int, kc: int,
                            group: int = GROUP):
    """queries (Q, D); codes (shard_rows, D) int8 and scales (shard_rows,)
    a shard (``pad_and_shard_db`` of the codes, the scales padded with 0 and
    split alike). Each shard proposes the exact top-kc of its approximate
    scores (``int8_candidates`` with kb >= kc blocks, as the reference's
    shard ``top_k``). Returns host (approx scores, global rows) of the
    top-kc candidates, for the caller's exact f32 rerank."""
    kc = min(int(kc), int(n_total))
    shard_rows = codes_sharded[0].shape[0]
    qs = _queries(mesh, queries)
    vals, idx = [], []
    for i, (codes, scales) in enumerate(zip(codes_sharded, scales_sharded)):
        valid = _local_valid(int(n_total), i, shard_rows)
        if valid <= 0:
            continue
        v, r = int8_candidates(qs[i], codes, scales, n_valid=valid,
                               kc=min(kc, valid), group=group)
        vals.append(v)
        idx.append(r + i * shard_rows)
    vals, idx = _merge_gathered_topk(vals, idx, kc)
    return _host(vals), _host(idx)


def build_sharded_paged(mesh: Mesh, data, cell_offsets, lpad: int,
                        cast_bf16: bool = False) -> dict:
    """Host cell-sorted rows/codes + offsets -> device-resident paged
    shards, cell-partitioned over 'dp' (build_paged_layout ->
    shard_paged_layout -> shard_paged_to_device)."""
    from ..ops.ivf_paged import build_paged_layout, shard_paged_layout

    lay = build_paged_layout(np.asarray(data), np.asarray(cell_offsets),
                             lpad)
    sh = shard_paged_layout(lay, mesh.shape["dp"])
    return shard_paged_to_device(mesh, sh, cast_bf16=cast_bf16)


def sharded_paged_plan(pg: dict, nprobe: int, dim: int, nq: int = 1):
    """(budget, chunk) shared by every shard: budget is the worst shard's
    worst case, as in the reference's SPMD program."""
    from ..ops.ivf_paged import default_chunk, paged_budget

    budget = max(paged_budget(row, nprobe) for row in pg["page_count_host"])
    lpad = pg["paged"][0].shape[1]
    return budget, default_chunk(lpad, int(dim), budget, nq=nq)


def shard_paged_to_device(mesh: Mesh, sharded_layout: dict,
                          cast_bf16: bool = False) -> dict:
    """A ``shard_paged_layout`` result as lists of per-shard tensors, shard
    i on the i-th 'dp' device; pages bf16 with ``cast_bf16``. The
    replicated arrays (centroids, codebooks) are the caller's."""
    devices = mesh.devices
    ndev = len(devices)

    def split(name):
        arr = np.asarray(sharded_layout[name])
        return [torch.from_numpy(np.ascontiguousarray(part)).to(dev)
                for part, dev in zip(np.split(arr, ndev), devices)]

    paged = split("paged")
    if cast_bf16:
        paged = [p.to(torch.bfloat16) for p in paged]
    return {
        "paged": paged,
        "page_rows": split("page_rows"),
        "page_first": [p[0] for p in split("page_first")],
        "page_count": [p[0] for p in split("page_count")],
        "page_count_host": np.asarray(sharded_layout["page_count_host"]),
    }


def _paged_topk(mesh, core, queries, centroids, pg, extra, k: int, **plan):
    """``core`` on every shard that owns a page, then the merge."""
    qs = _queries(mesh, queries)
    cents = _per_shard(mesh, centroids)
    vals, idx = [], []
    for i in range(mesh.shape["dp"]):
        if not pg["page_count_host"][i].any():
            continue
        v, r = core(qs[i], cents[i], pg["page_first"][i],
                    pg["page_count"][i], pg["paged"][i], pg["page_rows"][i],
                    *(arg[i] for arg in extra), k=k, **plan)
        vals.append(v)
        idx.append(r)
    vals, idx = _merge_gathered_topk(vals, idx, k)
    return _host(vals), _host(idx)


def sharded_ivf_paged_topk(mesh: Mesh, queries, centroids, pg: dict,
                           nprobe: int, k: int, chunk: int, budget: int):
    """Multi-device paged IVF-Flat: ``pg`` from shard_paged_to_device.
    Returns host (scores, global cell-sorted rows)."""
    from ..ops.ivf_paged import paged_flat_core

    return _paged_topk(mesh, paged_flat_core, queries, centroids, pg, (),
                       int(k), nprobe=int(nprobe), budget=int(budget),
                       chunk=int(chunk))


def sharded_ivfpq_paged_topk(mesh: Mesh, queries, centroids, pg: dict,
                             codebooks, nprobe: int, k: int, chunk: int,
                             budget: int):
    """Multi-device paged IVF-PQ ADC over cell-partitioned uint8 code
    pages."""
    from ..ops.ivf_paged import paged_pq_core

    return _paged_topk(mesh, paged_pq_core, queries, centroids, pg,
                       (_per_shard(mesh, codebooks),), int(k),
                       nprobe=int(nprobe), budget=int(budget),
                       chunk=int(chunk))

"""Paged IVF search: coarse probe + page gather + chunked scoring
(wise_tpu/ops/ivf_paged.py, the single-card half).

- **Paged layout** (built once at load): the cell-sorted rows are re-packed
  so every cell starts on a page boundary and occupies an integral number of
  fixed ``lpad``-row pages; one trailing all-padding page is the dummy target
  of unused slots. A page is one contiguous block of device memory, so the
  gather moves whole pages.
- **Page-list construction** without a per-cell loop: probed cells are
  re-sorted ascending, their page counts cumsummed, and each of ``budget``
  slots finds its cell with a batched ``searchsorted``.
- **Chunked scan**: the page list is processed ``chunk`` pages at a time, a
  Python loop of budget / chunk steps (``_scan_pages``); each step is one
  page gather, the chunk's scores and a running top-k merge. IVF-Flat scores
  a chunk with one einsum over the gathered (Q, chunk, lpad, D) rows;
  IVF-PQ gathers (Q, chunk, lpad, M) uint8 codes and sums their entries of
  the query's ADC tables.

``budget`` is the worst-case page count for the given nprobe
(``paged_budget``); queries that probe fewer pages pad with the dummy page.

Tie-break matches faiss (equal scores -> lower row id): probed cells are
ascending, pages within a cell ascending, lanes within a page ascending, and
earlier chunks hold lower rows; every selection is a stable sort, which keeps
the first occurrence (``torch.topk`` does not promise to).

Plain torch ops: the reference leaves this path to XLA. ``build_paged_layout``
is numpy, copied from the reference. The reference's IVF-PQ core scores
codes by one-hot matmuls, because gathers are what a TPU does slowly; here
the ADC is its plain form, a ``torch.gather`` of table entries. The
multi-device partitioning, ``shard_paged_layout``, is numpy, copied from the
reference; parallel/sharded_search.py runs the cores above on its shards.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .topk import _merge_topk, _stable_topk


def build_paged_layout(
    data: np.ndarray, cell_offsets: np.ndarray, lpad: int
) -> dict:
    """Re-pack cell-sorted rows (vectors or PQ codes) into cell-aligned pages.

    Returns dict with:
      paged      (T+1, lpad, W)  rows re-packed; final page is all padding
      page_rows  (T+1, lpad)     cell-sorted row index per lane, -1 = padding
      page_first (nlist,) int32  first page of each cell
      page_count (nlist,) int32  pages per cell
    """
    data = np.ascontiguousarray(data)
    n, w = data.shape
    offsets = np.asarray(cell_offsets, dtype=np.int64)
    nlist = len(offsets) - 1
    lens = np.diff(offsets)
    page_count = ((lens + lpad - 1) // lpad).astype(np.int32)
    page_first = np.zeros(nlist, np.int32)
    np.cumsum(page_count[:-1], out=page_first[1:])
    total = int(page_count.sum())

    paged = np.zeros((total + 1, lpad, w), dtype=data.dtype)
    page_rows = np.full((total + 1) * lpad, -1, np.int32)
    if n:
        cell_of_row = np.repeat(np.arange(nlist), lens)
        within = np.arange(n, dtype=np.int64) - offsets[cell_of_row]
        dest = page_first[cell_of_row].astype(np.int64) * lpad + within
        paged.reshape((total + 1) * lpad, w)[dest] = data
        page_rows[dest] = np.arange(n, dtype=np.int32)
    return {
        "paged": paged,
        "page_rows": page_rows.reshape(total + 1, lpad),
        "page_first": page_first,
        "page_count": page_count,
    }


def paged_budget(page_count: np.ndarray, nprobe: int) -> int:
    """Worst-case pages any query can probe = sum of the nprobe largest
    per-cell page counts."""
    c = np.sort(np.asarray(page_count))[::-1]
    return max(1, int(c[: int(nprobe)].sum()))


def default_chunk(lpad: int, width: int, budget: int, nq: int = 1,
                  target_bytes: int = 32 << 20) -> int:
    """Pages per scan step such that the per-step f32 working buffer stays
    around ``target_bytes``. The gather materialises a per-query buffer (Q,
    chunk, lpad, width), so the chunk shrinks with the query batch."""
    per_page = lpad * max(width, 1) * 4 * max(int(nq), 1)
    return max(1, min(budget, target_bytes // per_page))


def _probe_pages(q, centroids, page_first, page_count, nprobe, budget, dummy):
    """Top-nprobe cells (ascending) -> (pages (Q, budget), probed-cell coarse
    score per slot (Q, budget)). Out-of-budget slots map to the dummy page."""
    cscores = q @ centroids.float().T                      # (Q, nlist)
    pscores, cells = _stable_topk(cscores, nprobe)
    cells, order = torch.sort(cells, dim=1)                # ascending cells
    pscores = torch.gather(pscores, 1, order)

    counts = page_count.long()[cells]                      # (Q, nprobe)
    ends = torch.cumsum(counts, dim=1)                     # inclusive
    slot = torch.arange(budget, device=q.device)
    ci = torch.searchsorted(
        ends, slot[None, :].expand(q.shape[0], -1).contiguous(), right=True)
    ci = ci.clamp(max=nprobe - 1)
    sel_count = torch.gather(counts, 1, ci)
    sel_end = torch.gather(ends, 1, ci)
    sel_cell = torch.gather(cells, 1, ci)
    page = page_first.long()[sel_cell] + (slot[None, :]
                                          - (sel_end - sel_count))
    in_budget = slot[None, :] < ends[:, -1:]
    page = torch.where(in_budget, page, torch.full_like(page, dummy))
    return page, torch.gather(pscores, 1, ci)


def _pad_cols(x, chunk, fill):
    pad = (-x.shape[1]) % chunk
    return torch.nn.functional.pad(x, (0, pad), value=fill) if pad else x


def _scan_pages(pages, chunk: int, k: int, score_chunk):
    """Walk the (Q, budget) page list ``chunk`` pages at a time with a
    running (Q, k) top-k. ``score_chunk(lo, pg)`` gives the scores and
    cell-sorted rows (both (Q, chunk * lpad)) of pages ``pg`` = ``pages[:,
    lo:lo + chunk]``, padding lanes at -inf."""
    nq = pages.shape[0]
    best_v = torch.full((nq, k), float("-inf"), device=pages.device)
    best_r = torch.zeros((nq, k), dtype=torch.int64, device=pages.device)
    for lo in range(0, pages.shape[1], chunk):
        s, rows = score_chunk(lo, pages[:, lo:lo + chunk])
        v, pos = _stable_topk(s, min(k, s.shape[1]))
        best_v, best_r = _merge_topk(best_v, best_r, v,
                                     torch.gather(rows, 1, pos), k)
    return best_v, best_r


def paged_flat_core(queries, centroids, page_first, page_count, paged_db,
                    page_rows, nprobe: int, budget: int, chunk: int, k: int):
    """IVF-Flat paged search. queries (Q, D) f32; centroids (nlist, D) f32;
    page_first, page_count (nlist,) int32; paged_db (T+1, lpad, D) f32 or
    bf16, last page dummy; page_rows (T+1, lpad) int32, -1 = padding ->
    (scores (Q, k), cell-sorted rows (Q, k)); empty slots score -inf."""
    q = queries.to(device=paged_db.device, dtype=torch.float32)
    nq = q.shape[0]
    dummy = paged_db.shape[0] - 1
    lpad = paged_db.shape[1]
    pages, _ = _probe_pages(q, centroids, page_first, page_count, nprobe,
                            budget, dummy)
    pages = _pad_cols(pages, chunk, dummy)
    bf16 = paged_db.dtype == torch.bfloat16
    # bf16 storage: bf16 query operand, f32 products and sums
    qd = q.to(torch.bfloat16).float() if bf16 else q

    def score(lo, pg):
        blocks = paged_db[pg].float()                # (Q, chunk, lpad, D)
        rows = page_rows[pg].long()                  # (Q, chunk, lpad)
        s = torch.einsum("qd,qcld->qcl", qd, blocks)
        s = s.masked_fill(rows < 0, float("-inf"))
        return s.reshape(nq, -1), rows.reshape(nq, -1)

    return _scan_pages(pages, chunk, k, score)


ivf_search_paged = paged_flat_core


@contextlib.contextmanager
def _ieee_f32():
    """f32 products without TF32 inside the block, whatever the process set
    (``torch.backends.cuda.matmul.allow_tf32``), restored after it."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def paged_pq_core(queries, centroids, page_first, page_count, paged_codes,
                  page_rows, codebooks, nprobe: int, budget: int, chunk: int,
                  k: int):
    """IVF-PQ paged search by ADC over residual codes: score = q . centroid
    + sum_m tables[q, m, code_m], tables[q, m] = q_m . codebooks[m] (f32, no
    TF32). queries (Q, D) f32 (OPQ-rotated by the caller where the index
    has a rotation); centroids, page_first, page_count, page_rows as
    ``paged_flat_core``; paged_codes (T+1, lpad, M) uint8, last page dummy;
    codebooks (M, ksub, D/M) f32 -> (scores (Q, k), cell-sorted rows (Q,
    k)); empty slots score -inf.

    A row's M table entries are summed in f32 in the order m = 0 .. M-1,
    then the probe score is added, as the reference's loop does, so that
    scores agree to rounding and near-ties break alike."""
    q = queries.to(device=paged_codes.device, dtype=torch.float32)
    nq = q.shape[0]
    dummy = paged_codes.shape[0] - 1
    m, ksub, dsub = codebooks.shape
    with _ieee_f32():
        pages, slot_ps = _probe_pages(q, centroids, page_first, page_count,
                                      nprobe, budget, dummy)
        tables = torch.einsum("qmd,mkd->qmk", q.reshape(nq, m, dsub),
                              codebooks.float())
    pages = _pad_cols(pages, chunk, dummy)
    slot_ps = _pad_cols(slot_ps, chunk, 0.0)
    flat_tables = tables.reshape(nq, m * ksub)
    book_base = torch.arange(m, device=q.device) * ksub      # (M,)

    def score(lo, pg):
        codes = paged_codes[pg].long()               # (Q, chunk, lpad, M)
        rows = page_rows[pg].long()                  # (Q, chunk, lpad)
        lanes = codes.shape[1] * codes.shape[2]
        ent = torch.gather(flat_tables, 1,
                           (codes + book_base).reshape(nq, lanes * m))
        ent = ent.reshape(nq, codes.shape[1], codes.shape[2], m)
        s = ent[..., 0]
        for mi in range(1, m):
            s = s + ent[..., mi]
        s = s + slot_ps[:, lo:lo + pg.shape[1], None]
        s = s.masked_fill(rows < 0, float("-inf"))
        return s.reshape(nq, -1), rows.reshape(nq, -1)

    return _scan_pages(pages, chunk, k, score)


ivfpq_search_paged = paged_pq_core


def shard_paged_layout(layout: dict, ndev: int) -> dict:
    """Partition a ``build_paged_layout`` result into ``ndev`` contiguous
    CELL ranges balanced by page count, so every device runs the unmodified
    paged core on its own shard.

    Cells stay whole (a cell's pages never span devices) and ranges are
    contiguous in cell order, so each device covers an ascending contiguous
    global-row range: the device-major candidate merge keeps the faiss
    lowest-row tie-break for free.

    Returns the shards stacked along the leading axis
    (``parallel/sharded_search.py`` ``shard_paged_to_device`` splits them):
      paged       (ndev*(Tm+1), lpad, W)  per-device pages + dummy page
      page_rows   (ndev*(Tm+1), lpad)     GLOBAL cell-sorted row ids, -1 pad
      page_first  (ndev, nlist) int32     device-local first page (0 if unowned)
      page_count  (ndev, nlist) int32     per-cell pages (0 if unowned)
    plus ``page_count_host`` (ndev, nlist) for budget computation
    (budget for nprobe = max over devices of paged_budget(row, nprobe)).
    """
    page_count = np.asarray(layout["page_count"], np.int64)
    page_first = np.asarray(layout["page_first"], np.int64)
    paged = layout["paged"]
    page_rows = layout["page_rows"]
    nlist = len(page_count)
    lpad, w = paged.shape[1], paged.shape[2]
    total = int(page_count.sum())

    # contiguous cell ranges with ~equal pages: split points on the page
    # cumsum, assigning each boundary cell to whichever side leaves the
    # cumulative count closer to the ideal split (always forcing it left
    # can starve trailing devices, e.g. page_count=[1,3] over 2 devices)
    cum = np.cumsum(page_count)
    targets = total * (np.arange(1, ndev) / ndev)
    idx = np.searchsorted(cum, targets, side="left")
    cum_ext = np.concatenate([[0], cum])
    take_right = np.abs(cum_ext[idx] - targets) <= np.abs(
        cum_ext[np.minimum(idx + 1, nlist)] - targets
    )
    bounds = np.concatenate(
        [[0], np.where(take_right, idx, idx + 1), [nlist]]
    )
    bounds = np.minimum(bounds, nlist)
    bounds = np.maximum.accumulate(bounds)

    counts_sh = np.zeros((ndev, nlist), np.int32)
    first_sh = np.zeros((ndev, nlist), np.int32)
    chip_pages = []
    for dev in range(ndev):
        c0, c1 = int(bounds[dev]), int(bounds[dev + 1])
        counts_sh[dev, c0:c1] = page_count[c0:c1]
        base = int(page_first[c0]) if c1 > c0 else 0
        first_sh[dev, c0:c1] = (page_first[c0:c1] - base).astype(np.int32)
        npages = int(page_count[c0:c1].sum())
        chip_pages.append((base, npages))
    t_max = max(cnt for _, cnt in chip_pages)

    paged_sh = np.zeros((ndev, t_max + 1, lpad, w), paged.dtype)
    rows_sh = np.full((ndev, t_max + 1, lpad), -1, np.int32)
    for dev, (base, npages) in enumerate(chip_pages):
        paged_sh[dev, :npages] = paged[base:base + npages]
        rows_sh[dev, :npages] = page_rows[base:base + npages]
    return {
        "paged": paged_sh.reshape(ndev * (t_max + 1), lpad, w),
        "page_rows": rows_sh.reshape(ndev * (t_max + 1), lpad),
        "page_first": first_sh,
        "page_count": counts_sh,
        "page_count_host": counts_sh,
    }

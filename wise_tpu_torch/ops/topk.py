"""Inner-product top-k over a device-resident vector database
(wise_tpu/ops/topk.py).

``flat_topk`` is the exact search. Ordering is (score descending, row
ascending), the faiss order; rows ``>= n_valid`` (zero padding, which would
outscore negative true scores) are set to -inf before any selection.

- A CUDA database runs the hand-written kernels of ``ops/fused_topk.py``
  (csrc/topk_kernels.cu), by :func:`routes_to_threshold`: one query, or a
  batch of up to ``THRESHOLD_MAX_BATCH`` with k <= 50, goes to
  ``fused_topk_threshold`` (the fused form of ``two_stage_topk``: a running
  top-k that only looks at rows that can beat its k-th score, one read of
  the database for up to 16 queries); a larger batch or k goes to
  ``fused_topk`` (the fused form of ``hier_topk``: each group's own top-k,
  then a merge, one read for up to 64 queries). Neither
  materialises the (Q, N) score matrix. k beyond a group, or beyond the
  kernels' buffer (``fused_topk.MAX_K``), takes one stable sort over the
  whole score matrix in plain torch ops, the arm the reference leaves to XLA
  and neither Pallas kernel covers.
- A CPU database runs plain torch ops: one matmul (f32, or bf16 storage read
  as exact f32 values, so the sums are f32 either way) and the reference's
  two-stage selection: the k blocks of ``group`` rows with the highest maxima
  hold every top-k score, and only those candidates are ordered.
  ``torch.topk`` does not promise an order on ties, so every selection here
  is a stable descending sort.

Beside it, as plain torch ops (the reference leaves them to XLA):
``scan_topk`` (block by block with a running merge), ``flat_topk_approx``
(bucket maxima; recall-targeted, not exact), ``int8_candidates`` (the
1-byte-per-element candidate scan) with the numpy halves
``quantize_rows_int8`` and ``rerank_exact_f32``, copied from the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def pad_rows(db, group: int):
    """Zero-pad (N, D) rows to a multiple of ``group`` (at least one group)."""
    n = db.shape[0]
    n_pad = max(group, -(-n // group) * group)
    if n_pad == n:
        return db
    return torch.cat([db, db.new_zeros((n_pad - n, db.shape[1]))])


def _scores(queries, db_padded):
    q = queries.to(device=db_padded.device, dtype=torch.float32)
    if db_padded.dtype == torch.float32:
        return q @ db_padded.T
    # bf16 storage: bf16 query operand, f32 sums (products of bf16 values are
    # exact in f32)
    return q.to(torch.bfloat16).float() @ db_padded.float().T


def _masked_scores(queries, db_padded, n_valid: int):
    scores = _scores(queries, db_padded)
    row = torch.arange(db_padded.shape[0], device=scores.device)
    return scores.masked_fill((row >= n_valid)[None, :], float("-inf"))


def _stable_topk(x, k: int):
    vals, pos = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], pos[:, :k]


def _merge_topk(run_vals, run_idx, new_vals, new_idx, k: int):
    """Merge two (Q, k) top-k sets. The running set comes first, so the
    stable sort prefers its (lower-row) entries on ties."""
    vals = torch.cat([run_vals, new_vals], dim=1)
    idx = torch.cat([run_idx, new_idx], dim=1)
    top_vals, pos = _stable_topk(vals, k)
    return top_vals, torch.gather(idx, 1, pos)


def running_topk(score_block, n_blocks: int, block_rows: int, nq: int,
                 k: int, device):
    """Walk ``n_blocks`` blocks of ``block_rows`` rows with a running (Q, k)
    top-k: ``score_block(b)`` gives block b's masked (Q, block_rows) scores.
    Ties keep the lower row (earlier blocks first, stable sorts)."""
    vals = torch.full((nq, k), float("-inf"), device=device)
    idx = torch.zeros((nq, k), dtype=torch.int64, device=device)
    for b in range(n_blocks):
        loc_vals, loc_pos = _stable_topk(score_block(b), k)
        vals, idx = _merge_topk(vals, idx, loc_vals,
                                loc_pos + b * block_rows, k)
    return vals, idx


def scan_topk(queries, db, k: int, block_rows: int = 4096, n_valid=None):
    """queries (Q, D), db (N, D) -> (scores (Q, k), rows (Q, k)): the
    database walked in row blocks with a running top-k, never an (N, Q)
    score matrix. N pads to a block multiple internally; padded rows, and
    with ``n_valid`` rows >= n_valid, score -inf before the block's top-k."""
    q = queries.to(device=db.device, dtype=torch.float32)
    n = db.shape[0]
    k = min(int(k), n)
    block_rows = max(min(int(block_rows), -(-n // 8) * 8), -(-k // 8) * 8)
    n_blocks = -(-n // block_rows)
    limit = n if n_valid is None else min(n, int(n_valid))

    def score_block(b):
        lo = b * block_rows
        block = db[lo:lo + block_rows].float()
        scores = q @ block.T
        if block.shape[0] < block_rows:
            scores = torch.nn.functional.pad(
                scores, (0, block_rows - block.shape[0]))
        row = torch.arange(lo, lo + block_rows, device=db.device)
        return scores.masked_fill((row >= limit)[None, :], float("-inf"))

    return running_topk(score_block, n_blocks, block_rows, q.shape[0], k,
                        db.device)


def _block_max_topk(scores, kb: int, k: int, group: int):
    """The top-k of masked (Q, N_pad) scores by block-max candidate
    selection: the ``kb`` blocks of ``group`` rows with the highest maxima,
    in ascending block order (which keeps the row order on ties), then one
    stable top-k over their kb * group scores."""
    qn, nb = scores.shape[0], scores.shape[1] // group
    blocks = scores.view(qn, nb, group)
    _, blk = _stable_topk(blocks.amax(dim=2), kb)
    blk, _ = torch.sort(blk, dim=1)
    cand = torch.gather(
        blocks, 1, blk[:, :, None].expand(-1, -1, group)).reshape(qn, -1)
    base = (blk[:, :, None] * group
            + torch.arange(group, device=scores.device)).reshape(qn, -1)
    vals, pos = _stable_topk(cand, min(k, cand.shape[1]))
    return vals, torch.gather(base, 1, pos)


#: the largest batch that goes to ``fused_topk_threshold`` at k <= 50 (one
#: query goes there at any k). The reference's dispatcher sends up to 128;
#: the port's threshold scan reads the database once for 16 queries and
#: the group path once for 64. At 1,048,576 x 512 on an NVIDIA H100 80GB
#: HBM3 (700 W), chip_smoke.py's ``q32-k10-f32`` rows took 1.50-1.52 ms on
#: the threshold scan (two reads) against 1.07-1.13 on ``fused_topk``, and
#: its ``q16-k10-f32`` row 0.90-0.92 on the scan (PERF.md §6)
THRESHOLD_MAX_BATCH = 16
#: the largest k a batch of more than one query takes to the threshold scan
THRESHOLD_MAX_K = 50


def routes_to_threshold(qn: int, k: int) -> bool:
    """Whether ``flat_topk`` on a CUDA database sends Q = ``qn`` queries at
    ``k`` (within the kernels' range) to ``fused_topk_threshold`` rather
    than to ``fused_topk``."""
    return qn <= 1 or (k <= THRESHOLD_MAX_K and qn <= THRESHOLD_MAX_BATCH)


def flat_topk(queries, db_padded, n_valid: int, k: int, group: int = 4096):
    """queries (Q, D), db_padded (N_pad, D) with N_pad % group == 0 ->
    (scores (Q, k'), rows (Q, k')) with k' = min(k, n_valid)."""
    n_pad = db_padded.shape[0]
    if n_pad % group:
        raise ValueError(f"db rows {n_pad} not a multiple of group {group}")
    k = min(int(k), int(n_valid))
    if db_padded.is_cuda:
        from . import fused_topk as F  # imports this module: not at the top

        if k <= min(group, F.MAX_K):
            if routes_to_threshold(queries.shape[0], k):
                return F.fused_topk_threshold(queries, db_padded, n_valid, k,
                                              group)
            return F.fused_topk(queries, db_padded, n_valid, k, group)
        return _stable_topk(_masked_scores(queries, db_padded, n_valid), k)
    scores = _masked_scores(queries, db_padded, n_valid)
    if k > group:
        return _stable_topk(scores, k)
    return _block_max_topk(scores, min(k, n_pad // group), k, group)


def approx_buckets(n_pad: int, k: int, recall_target: float) -> int:
    """How many buckets ``flat_topk_approx`` keeps one maximum of: the TPU
    op's sizing, about (k - 1) / (1 - recall_target) (a top-k entry is lost
    when it shares a bucket with a better one), rounded up to n_pad over a
    power of two that divides it."""
    if recall_target >= 1.0:
        return n_pad
    want = max(k, math.ceil((k - 1) / (1.0 - recall_target)))
    size = 1
    while n_pad % (2 * size) == 0 and n_pad // (2 * size) >= want:
        size *= 2
    return n_pad // size


def flat_topk_approx(queries, db_padded, n_valid: int, k: int,
                     recall_target: float = 0.95):
    """APPROXIMATE flat top-k, the port's counterpart of the reference's
    ``jax.lax.approx_max_k`` path, which has no torch equivalent. Defined
    here: row i of the masked score row falls into bucket i mod L, L =
    ``approx_buckets``; each bucket keeps its maximum; the result is the
    exact ordered top-k of the L maxima. Every returned (score, row) pair is
    a true one; a top-k entry is missing when a better one shares its
    bucket, so the expected recall on unordered data is about
    1 - (k - 1) / L >= recall_target. Held to recall, not to ids."""
    k = min(int(k), int(n_valid))
    scores = _masked_scores(queries, db_padded, n_valid)
    qn, n_pad = scores.shape
    buckets = approx_buckets(n_pad, k, recall_target)
    vals, pos = scores.view(qn, n_pad // buckets, buckets).max(dim=1)
    rows = pos * buckets + torch.arange(buckets, device=scores.device)
    # (score descending, row ascending): rows first, then a stable score sort
    rows, order = torch.sort(rows, dim=1, stable=True)
    top, pos = _stable_topk(torch.gather(vals, 1, order), k)
    return top, torch.gather(rows, 1, pos)


def quantize_rows_int8(db: np.ndarray):
    """Symmetric per-row int8 quantization: returns (codes (N, D) int8,
    scales (N,) f32) with row = codes * scale + err, |err| <= scale/2.
    Zero rows get scale 0 (codes 0) so padding scores exactly 0 like the
    f32 path before masking."""
    db = np.asarray(db, dtype=np.float32)
    absmax = np.abs(db).max(axis=1)
    scales = absmax / 127.0
    inv = np.where(scales > 0, 1.0 / np.where(scales == 0, 1, scales), 0.0)
    codes = np.rint(db * inv[:, None]).astype(np.int8)
    return codes, scales.astype(np.float32)


#: rows of int8 codes converted to f32 at a time by ``int8_candidates``
INT8_CHUNK_ROWS = 65536


def int8_candidates(queries, db_i8, row_scales, n_valid: int, kc: int,
                    k=None, group: int = 4096):
    """Approximate top-kc candidate rows from an int8-quantized database:
    the query quantizes to int8 as well, the integer dot products rescale by
    the query's and the row's scales, and the block-max selection of
    ``flat_topk`` picks kc candidates. Exactness is restored by the caller
    re-scoring the candidates in f32 (``rerank_exact_f32``). Returns (approx
    scores (Q, kc) f32, rows (Q, kc)).

    The integer sums are taken as f32 matmuls over f32 copies of the codes,
    made ``INT8_CHUNK_ROWS`` rows at a time (a whole-database copy would
    undo what int8 storage saves): |code| <= 127, so every product and a sum
    of up to 1024 of them is exact in f32 (127^2 * 1024 < 2^24), like the
    reference's bf16-operand dot. A bf16 torch matmul would round its output
    to bf16 and lose that."""
    n_pad = db_i8.shape[0]
    if n_pad % group:
        raise ValueError(f"db rows {n_pad} not a multiple of group {group}")
    kc = min(int(kc), int(n_valid))
    q = queries.to(device=db_i8.device, dtype=torch.float32)
    q_scale = q.abs().amax(dim=1, keepdim=True) / 127.0
    q_codes = torch.round(q / torch.where(q_scale == 0, 1.0, q_scale))
    raw = torch.empty((q.shape[0], n_pad), dtype=torch.float32,
                      device=db_i8.device)
    for lo in range(0, n_pad, INT8_CHUNK_ROWS):
        hi = min(n_pad, lo + INT8_CHUNK_ROWS)
        raw[:, lo:hi] = q_codes @ db_i8[lo:hi].float().T
    scores = raw * (q_scale * row_scales[None, :])
    row = torch.arange(n_pad, device=scores.device)
    scores = scores.masked_fill((row >= n_valid)[None, :], float("-inf"))
    # kb >= the final k: the true top-k can occupy k distinct blocks (the
    # block-max argument, modulo the int8 margin); kc > k adds in-block margin
    k_floor = k if k is not None else kc
    kb = min(n_pad // group, max(k_floor, -(-kc // group), 8))
    return _block_max_topk(scores, kb, kc, group)


def rerank_exact_f32(queries, candidate_rows, vectors, k: int,
                     n_valid=None):
    """Host-side exact re-scoring of device-proposed candidates: gathers the
    candidate rows from the (memmapped) f32 store, scores in f32 with
    numpy's accumulation, and applies the faiss tie-break (equal scores
    prefer the lower row index). candidate_rows may contain duplicates or
    -1/-inf padding lanes; both are handled. Returns (scores (Q, k),
    rows (Q, k)) — identical to the full f32 scan whenever the true top-k
    is inside the candidate set."""
    queries = np.asarray(queries, dtype=np.float32)
    out_v = np.full((queries.shape[0], k), -np.inf, np.float32)
    out_r = np.zeros((queries.shape[0], k), np.int32)
    for qi in range(queries.shape[0]):
        rows = np.unique(candidate_rows[qi])
        rows = rows[rows >= 0]
        if n_valid is not None:
            # -inf candidate lanes still carry indices of padding rows
            rows = rows[rows < n_valid]
        cand = np.asarray(vectors[rows], dtype=np.float32)
        scores = cand @ queries[qi]
        order = np.lexsort((rows, -scores))[:k]
        out_v[qi, : len(order)] = scores[order]
        out_r[qi, : len(order)] = rows[order]
    return out_v, out_r


def numpy_reference_topk(queries, db, k):
    """O(N*Q) reference used by tests: same tie-break contract."""
    scores = queries.astype(np.float32) @ db.astype(np.float32).T
    k = min(k, db.shape[0])
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(scores, order, axis=1)
    return vals, order

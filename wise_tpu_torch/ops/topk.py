"""Exact inner-product top-k over a device-resident vector database
(wise_tpu/ops/topk.py ``flat_topk``).

One matmul of the queries against the padded database (f32, or bf16 storage
read as exact f32 values, so the sums are f32 either way), rows ``>=
n_valid`` set to -inf before any selection, then the reference's two-stage
selection: the k blocks of ``group`` rows with the highest maxima hold every
top-k score, and only those candidates are ordered. Ordering is (score
descending, row ascending), the faiss order: ``torch.topk`` does not promise
it on ties, so both stages use a stable descending sort.

Plain torch ops: the reference leaves this to XLA, not to a Pallas kernel.
"""

from __future__ import annotations

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


def _stable_topk(x, k: int):
    vals, pos = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], pos[:, :k]


def flat_topk(queries, db_padded, n_valid: int, k: int, group: int = 4096):
    """queries (Q, D), db_padded (N_pad, D) with N_pad % group == 0 ->
    (scores (Q, k'), rows (Q, k')) with k' = min(k, n_valid)."""
    n_pad = db_padded.shape[0]
    if n_pad % group:
        raise ValueError(f"db rows {n_pad} not a multiple of group {group}")
    k = min(int(k), int(n_valid))
    scores = _scores(queries, db_padded)
    row = torch.arange(n_pad, device=scores.device)
    scores = scores.masked_fill((row >= n_valid)[None, :], float("-inf"))
    if k > group:
        return _stable_topk(scores, k)
    qn, nb = scores.shape[0], n_pad // group
    blocks = scores.view(qn, nb, group)
    _, blk = _stable_topk(blocks.amax(dim=2), min(k, nb))
    blk, _ = torch.sort(blk, dim=1)  # ascending block order keeps row order
    cand = torch.gather(
        blocks, 1, blk[:, :, None].expand(-1, -1, group)).reshape(qn, -1)
    base = (blk[:, :, None] * group
            + torch.arange(group, device=scores.device)).reshape(qn, -1)
    vals, pos = _stable_topk(cand, k)
    return vals, torch.gather(base, 1, pos)

"""Fused inner-product scan + top-k: CUDA kernels and their plain versions,
the counterpart of ``wise_tpu/ops/pallas_topk.py``.

| wrapper              | TPU kernel it replaces                             |
| -------------------- | -------------------------------------------------- |
| fused_topk           | pallas_topk (pallas_topk.py:82)                    |
| fused_topk_threshold | pallas_topk_threshold (pallas_topk.py:221)         |

Both take the reference's arguments minus ``interpret``: queries (Q, D),
db_padded (N_pad, D) f32 or bf16 with N_pad % group == 0, ``n_valid``, ``k``,
``group``, and return (scores (Q, k'), rows (Q, k')), k' = min(k, n_valid).
f32 storage scores in full f32; bf16 storage meets the query rounded to bf16,
products and sums in f32. Rows >= n_valid are -inf before any selection.

The contract of both: the first k' of all valid rows ordered by (score
descending, row ascending), the order ``ops.topk.flat_topk`` returns. That is
stricter than the TPU threshold kernel, which evicts the first lane among tied
worsts and orders final ties by lane: here the running buffer compares by the
total order (score, then row), so the worst among tied scores is the highest
row, and the final ordering sorts ties by row.

On a CUDA database a wrapper launches its kernel (csrc/topk_kernels.cu) or
raises; the candidates of the kernel's spans or groups are merged here with
torch sorts, as the merge is outside both Pallas kernels. On a CPU database it
computes the plain version: group by group with a running merge, or each
group's own top-k and one merge. ``LAUNCHES`` counts the launches, keyed in
``LAUNCHES_BY_SHAPE`` by (wrapper, N_pad, D): the batch is the coalescer's
choice and is left out of the key.
"""

from __future__ import annotations

import torch

from .block import _require, _stream
from .build import LaunchCounter, check, load_library, refuse_grad
from .topk import _scores, _stable_topk, running_topk

#: the largest k the kernels' shared-memory buffer holds
MAX_K = 1024
#: the widest rows the kernels' query tile holds
MAX_D = 1024
#: CTAs per SM the threshold kernel's spans are sized for
_CTAS_PER_SM = 8

_launches = LaunchCounter("fused_topk", "fused_topk_threshold")
#: kernel launches since the last reset_launches()
LAUNCHES = _launches.counts
#: the same launches keyed by (wrapper, N_pad, D)
LAUNCHES_BY_SHAPE = _launches.by_shape
reset_launches = _launches.reset


def _group_scores(queries, db_padded, n_valid: int, group: int):
    """b -> group b's (Q, group) scores, rows >= n_valid at -inf."""
    def score_block(b):
        lo = b * group
        scores = _scores(queries, db_padded[lo:lo + group])
        row = torch.arange(lo, lo + group, device=scores.device)
        return scores.masked_fill((row >= n_valid)[None, :], float("-inf"))

    return score_block


def _check_plain(db_padded, n_valid, k, group):
    n_pad = db_padded.shape[0]
    _require(n_pad % group == 0,
             f"db rows {n_pad} not a multiple of group {group}")
    k = min(int(k), int(n_valid))
    _require(1 <= k <= group, f"k {k} not in [1, group {group}]")
    return n_pad, k


def fused_topk_threshold_plain(queries, db_padded, n_valid: int, k: int,
                               group: int = 4096):
    """Plain PyTorch: the groups one after another with a running top-k."""
    n_pad, k = _check_plain(db_padded, n_valid, k, group)
    return running_topk(_group_scores(queries, db_padded, n_valid, group),
                        n_pad // group, group, queries.shape[0], k,
                        db_padded.device)


def fused_topk_plain(queries, db_padded, n_valid: int, k: int,
                     group: int = 4096):
    """Plain PyTorch: each group's own top-k, then one merge of the (Q,
    G * k) candidates (group-major, so a stable sort keeps the lower row on
    ties)."""
    n_pad, k = _check_plain(db_padded, n_valid, k, group)
    score_block = _group_scores(queries, db_padded, n_valid, group)
    vals, rows = [], []
    for b in range(n_pad // group):
        v, pos = _stable_topk(score_block(b), k)
        vals.append(v)
        rows.append(pos + b * group)
    vals, rows = torch.cat(vals, dim=1), torch.cat(rows, dim=1)
    top, pos = _stable_topk(vals, k)
    return top, torch.gather(rows, 1, pos)


def topk_agreement(got, want, tol: float = 0.0) -> dict:
    """Hold a (scores, rows) top-k result against the plain one. ``tol`` 0:
    scores and rows must be identical (integer-valued vectors, where every
    score is exact whatever the summation order). Otherwise: scores within
    ``tol`` position by position, and rows equal except where the plain
    score has a neighbour within ``tol`` (two near-tied entries may swap) or
    at the last position (the k-th entry may swap with a near-tied row just
    outside). Returns ok, max_abs_err and the count of mismatched rows."""
    (gs, gr), (ws, wr) = got, want
    if gs.shape != ws.shape or gr.shape != wr.shape:
        return {"ok": False, "max_abs_err": float("inf"), "mismatched": -1}
    gs, ws = gs.float(), ws.float()
    err = torch.where(gs == ws, torch.zeros_like(gs), (gs - ws).abs())
    err = float(err.max()) if err.numel() else 0.0
    diff = gr.long() != wr.long()
    if tol == 0.0:
        ok = err == 0.0 and not bool(diff.any())
    else:
        gap = (ws[:, :-1] - ws[:, 1:]) <= tol
        near = torch.zeros_like(diff)
        near[:, 1:] |= gap
        near[:, :-1] |= gap
        near[:, -1] = True
        ok = err <= tol and not bool((diff & ~near).any())
    return {"ok": bool(ok), "max_abs_err": err, "mismatched": int(diff.sum())}


def _merge(out_s, out_r, k: int):
    """(slots, Q, k) unsorted candidates -> the first k by (score
    descending, row ascending): rows first, then a stable score sort."""
    qn = out_s.shape[1]
    s = out_s.permute(1, 0, 2).reshape(qn, -1)
    r = out_r.permute(1, 0, 2).reshape(qn, -1)
    r, order = torch.sort(r, dim=1, stable=True)
    vals, pos = _stable_topk(torch.gather(s, 1, order), k)
    return vals, torch.gather(r, 1, pos).long()


def _launch(name, queries, db_padded, n_valid, k, group, threshold):
    refuse_grad(name, (queries, db_padded),
                "a search is not differentiated in either package")
    _require(db_padded.dim() == 2 and db_padded.is_contiguous()
             and db_padded.dtype in (torch.float32, torch.bfloat16),
             f"{name}: db must be a contiguous (N_pad, D) float32 or "
             f"bfloat16 tensor")
    n_pad, d = db_padded.shape
    _require(queries.dim() == 2 and queries.shape[1] == d
             and queries.shape[0] >= 1,
             f"{name}: queries must be (Q, {d}), got {tuple(queries.shape)}")
    _require(d % 8 == 0 and 8 <= d <= MAX_D,
             f"{name}: width {d} not a multiple of 8 in [8, {MAX_D}]")
    _require(group >= 1 and n_pad >= group and n_pad % group == 0,
             f"{name}: db rows {n_pad} not a multiple of group {group}")
    _require(n_pad < 2 ** 31 and n_pad // group <= 65535,
             f"{name}: {n_pad} rows in groups of {group} exceed the grid")
    _require(1 <= n_valid <= n_pad,
             f"{name}: n_valid {n_valid} not in [1, {n_pad}]")
    k = min(int(k), int(n_valid))
    _require(1 <= k <= min(group, MAX_K),
             f"{name}: k {k} not in [1, min(group {group}, {MAX_K})]")
    _require(db_padded.data_ptr() % 16 == 0,
             f"{name}: db must be 16-byte aligned")
    dev = db_padded.device
    q = queries.to(device=dev, dtype=torch.float32).contiguous()
    qn, groups = q.shape[0], n_pad // group
    lib = load_library()
    bf16_db = int(db_padded.dtype == torch.bfloat16)
    if threshold:
        # spans of whole groups, as many as fill the card
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        tiles = 1 if qn == 1 else -(-qn // 8)
        span_groups = max(1, groups * tiles // (_CTAS_PER_SM * sms))
        slots = -(-groups // span_groups)
    else:
        slots = groups
    out_s = torch.empty((slots, qn, k), dtype=torch.float32, device=dev)
    out_r = torch.empty((slots, qn, k), dtype=torch.int32, device=dev)
    args = (q.data_ptr(), db_padded.data_ptr(), bf16_db, out_s.data_ptr(),
            out_r.data_ptr(), qn, d, n_pad, int(n_valid), k, int(group))
    with torch.cuda.device(dev):
        if threshold:
            err = lib.wt_topk_threshold(*args, span_groups, _stream(q))
        else:
            err = lib.wt_topk_group(*args, _stream(q))
    check(err, name)
    _launches.add(name, n_pad, d)
    return _merge(out_s, out_r, k)


def fused_topk_threshold(queries, db_padded, n_valid: int, k: int,
                         group: int = 4096):
    """The running top-k with the threshold skip: a CTA carries its buffer
    over a span of groups and looks only at rows that beat its k-th entry.
    The served query's kernel (Q = 1, and coalesced batches at small k)."""
    if not db_padded.is_cuda:
        return fused_topk_threshold_plain(queries, db_padded, n_valid, k,
                                          group)
    return _launch("fused_topk_threshold", queries, db_padded, n_valid, k,
                   group, threshold=True)


def fused_topk(queries, db_padded, n_valid: int, k: int, group: int = 4096):
    """Each group's own top-k in one CTA per (group, query tile), then the
    merge. The batched search's kernel. Exact for k <= group."""
    if not db_padded.is_cuda:
        return fused_topk_plain(queries, db_padded, n_valid, k, group)
    return _launch("fused_topk", queries, db_padded, n_valid, k, group,
                   threshold=False)

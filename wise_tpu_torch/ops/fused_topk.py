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

On a CUDA database a wrapper launches its kernels (csrc/topk_kernels.cu) or
raises; the group path's candidates are merged here with one keyed
``torch.topk`` (:func:`_merge`), as the merge is outside both Pallas
kernels, and the threshold scan merges its row ranges' in the kernel. On a
CPU database it computes the plain version: group by group with a running
merge, or each group's own top-k and one merge. ``LAUNCHES`` counts the
wrapper calls that launched, one a call whatever the number of kernels it
enqueued, keyed in ``LAUNCHES_BY_SHAPE`` by (wrapper, N_pad, D): the batch
is the coalescer's choice and is left out of the key.

``fused_topk`` on a CUDA database (the batched search) replaces pallas_topk
with two kernels a chunk, driven by :func:`group_topk_chunks`, on either
storage type. What bounds it is the database read (1,048,576 x 512: 1.07 GB
bf16, 2.15 GB f32; 0.32 / 0.64 ms at 3.35 TB/s), plus the Sᵀ scratch written
and read again (256 MB at Q = 64). So each chunk of whole groups by at most
64 queries reads its rows once, on the tensor cores, into Sᵀ (rows, Q_pad)
f32: bf16 storage through ``wt_topk_gemm`` (the port's GEMM,
csrc/common.cuh ``gemm_kernel``, on the rows as they lie and bf16(q)ᵀ); f32
storage through ``wt_topk_gemm_f32``, which scores to f32 accuracy from three
TF32 products (3xTF32, :func:`tf32_split`: hi·q_hi + hi·q_lo + lo·q_hi, the
dropped lo·lo ~2^-22 of each product, each 32-column stage's products summed
in f32 outside the tensor cores; no TF32-only product). Then
``wt_topk_select`` keeps each group's top-k of each query: the k-th largest
of 256 block maxima is a lower bound τ of the group's k-th best score, and
only the rows >= τ (~3% of a group at random scores) are sorted; ties at τ
that overflow its buffer take a buffer insertion over those rows alone
(counted by :func:`overflow_count`). :func:`_merge` then orders the
candidates with one ``torch.topk`` over an int64 key. The next step is the
selection fused into the product's epilogue, which drops the Sᵀ round trip.

``fused_topk_threshold`` (the served query: Q = 1, and coalesced batches at
small k) replaces pallas_topk_threshold with one kernel, ``wt_topk_threshold``
(``topk_scan_kernel``), bound by the same database read. One persistent CTA
an SM owns a range of whole 256-row blocks (a range may start and end inside
a group) and a tile of 1, 8 or 16 queries (:func:`scan_plan`), so that a
coalesced batch of up to 16 reads the rows once: a producer thread streams
the range through a ring of 32 KB stages by TMA (256 rows x 128 bytes,
128-byte swizzle), and eight consumer warps score them as they land, f32
FMAs against the queries in shared memory. The selection is off the scan's
critical path: each query keeps a threshold τ, the k-th best (score key,
~row) word so far; a row block's rows are voted against τ, and the few
survivors appended to the query's list (:func:`scan_tile` sizes it), which,
when full, is flushed to its first k by one bitonic sort, raising τ (counted
by :func:`flush_count`). bf16 storage at 8 or 16 queries scores on the
tensor cores instead (mma.sync m16n8k16: exact bf16 products, each k16
step's sum added in f32). Each range leaves its first k of each query in
(ranges, Q, k) candidates, and the last CTA of each query tile to finish
merges them through the same lists, so that a call is one launch.
"""

from __future__ import annotations

import torch

from .block import _require, _stream
from .build import LaunchCounter, check, load_library, refuse_grad
from .topk import _scores, _stable_topk, running_topk

#: the largest k the kernels' shared-memory buffer holds
MAX_K = 1024
#: the widest rows the kernels' query tile holds (csrc/topk_kernels.cu
#: kScanMaxD): ViT-bigG-14's 1280-d joint space
MAX_D = 1280
#: rows of one block of the threshold scan: a stage of its ring holds 128
#: bytes of each, and a CTA's range is whole blocks
SCAN_BLOCK_ROWS = 256
#: queries the threshold scan scores on one read of the rows
SCAN_QUERIES = 16
#: the most list entries a threshold scan CTA holds for its query tile
#: (32 KB of shared memory)
SCAN_LIST_WORDS = 4096
#: queries the group path scores in one product (before padding to 8)
CHUNK_QUERIES = 64
#: the Sᵀ scratch the group path holds: 1,048,576 rows x 64 queries x 4 B
CHUNK_SCRATCH_BYTES = 256 << 20

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


def scores_t_plain(db_rows, wq, out) -> None:
    """Plain version of the bf16 path's product (``wt_topk_gemm``): out
    (rows, Q_pad) f32 = Sᵀ of db_rows (rows, D) against the queries held as
    wq = bf16(q)ᵀ (D, Q_pad), by ``ops.topk._scores``."""
    out.copy_(_scores(wq.T, db_rows).T)


def scores_t_f32_plain(db_rows, qp, out) -> None:
    """Plain version of the f32 path's product (``wt_topk_gemm_f32``): out
    (rows, Q_pad) f32 = Sᵀ of db_rows (rows, D) f32 against the queries qp
    (Q_pad, D) f32, in full f32 by ``ops.topk._scores``."""
    out.copy_(_scores(qp, db_rows).T)


def tf32(x):
    """x (f32) rounded to TF32, to nearest with ties away from zero, as
    ``cvt.rna.tf32.f32`` does: the low 13 bits of the word cleared after
    adding half of their range to the magnitude."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_permutation(d_pad: int):
    """Column order of the f32 kernel's A fragments: in each block of 32
    columns, logical column 8kk + j (k8 step kk, fragment column j) is
    physical column 8j + 2kk for j < 4 and 8(j - 4) + 2kk + 1 for j >= 4
    (csrc/topk_kernels.cu topk_gemm_f32_kernel: a thread reads 8 physical
    columns of a row as two 16-byte pieces and takes two a k8 step)."""
    p = torch.arange(32)
    kk, j = p // 8, p % 8
    phys = torch.where(j < 4, 8 * j + 2 * kk, 8 * (j - 4) + 2 * kk + 1)
    return (torch.arange(0, d_pad, 32)[:, None] + phys[None, :]).reshape(-1)


def tf32_split(qp):
    """The f32 path's query operand: qp (Q_pad, D) f32 -> (2, Q_pad, d_pad)
    f32 = (q_hi, q_lo), q_hi = tf32(q), q_lo = tf32(q - q_hi), zero columns to
    d_pad = D rounded up to 32, each block of 32 columns in the kernel's
    fragment order (:func:`tf32_permutation`)."""
    qn, d = qp.shape
    d_pad = -(-d // 32) * 32
    q = torch.nn.functional.pad(qp.float(), (0, d_pad - d))
    hi = tf32(q)
    lo = tf32(q - hi)
    perm = tf32_permutation(d_pad).to(q.device)
    return torch.stack([hi, lo])[:, :, perm].contiguous()


def select_groups_plain(st, row0: int, n_valid: int, k: int, group: int,
                        out_s, out_r, q0: int, qc: int) -> None:
    """Plain version of the group path's selection (``wt_topk_select``): Sᵀ
    (rows, Q_pad) of database rows [row0, row0 + rows), whole groups, against
    queries [q0, q0 + qc) (its first qc columns) -> slots row0 / group, ...
    of out_s / out_r (groups, Q, k): each group's first k by (score
    descending, row ascending), rows >= n_valid at -inf, an entry at -inf
    leaving as row 0 as the kernel's empty slots do."""
    rows = st.shape[0]
    row = torch.arange(row0, row0 + rows, device=st.device)
    scores = st[:, :qc].T.masked_fill((row >= n_valid)[None, :],
                                      float("-inf"))
    vals, pos = torch.sort(scores.reshape(qc, rows // group, group), dim=2,
                           descending=True, stable=True)
    vals, pos = vals[:, :, :k], pos[:, :, :k]
    base = torch.arange(row0, row0 + rows, group, device=st.device)
    pos = torch.where(vals == float("-inf"), 0, pos + base[None, :, None])
    slots = slice(row0 // group, row0 // group + rows // group)
    out_s[slots, q0:q0 + qc] = vals.permute(1, 0, 2)
    out_r[slots, q0:q0 + qc] = pos.permute(1, 0, 2).to(out_r.dtype)


def group_topk_chunks(queries, db_padded, n_valid: int, k: int, group: int,
                      product, select, chunk_queries: int = CHUNK_QUERIES,
                      scratch_bytes: int = CHUNK_SCRATCH_BYTES):
    """The group path's host side: each group's own top-k of q @ dbᵀ, then
    one merge, with the product and the selection as callables (the kernels
    on the card; :func:`scores_t_plain` or :func:`scores_t_f32_plain` and
    :func:`select_groups_plain` in the CPU tests).

    The queries go in chunks of at most ``chunk_queries``, each padded with
    zero queries to a multiple of 8 (the product's TMA maps want a 16-byte
    row stride): on bf16 storage rounded to bf16 and held as Wq = bf16(q)ᵀ
    (D, Q_pad), on f32 storage kept f32 as (Q_pad, D). The groups go in
    chunks of as many whole groups as ``scratch_bytes`` of Sᵀ (rows, Q_pad)
    f32 hold (one at the least). For each (query chunk, group chunk):
    ``product(db rows, queries, st)`` writes Sᵀ, ``select(st, row0, n_valid,
    k, group, out_s, out_r, q0, qc)`` writes the chunk's slots of the
    (groups, Q, k) candidates, which :func:`_merge` orders."""
    n_pad, d = db_padded.shape
    qn, groups, dev = queries.shape[0], n_pad // group, db_padded.device
    bf16 = db_padded.dtype == torch.bfloat16
    qs = queries.to(device=dev,
                    dtype=torch.bfloat16 if bf16 else torch.float32)
    out_s = torch.empty((groups, qn, k), dtype=torch.float32, device=dev)
    out_r = torch.empty((groups, qn, k), dtype=torch.int32, device=dev)
    width = -(-min(qn, chunk_queries) // 8) * 8
    chunk_groups = max(1, min(groups, scratch_bytes // (4 * group * width)))
    scratch = torch.empty(chunk_groups * group * width, dtype=torch.float32,
                          device=dev)
    for q0 in range(0, qn, chunk_queries):
        qc = min(chunk_queries, qn - q0)
        q_pad = -(-qc // 8) * 8
        op = torch.zeros((q_pad, d), dtype=qs.dtype, device=dev)
        op[:qc] = qs[q0:q0 + qc]
        if bf16:
            op = op.T.contiguous()
        for g0 in range(0, groups, chunk_groups):
            rows = min(chunk_groups, groups - g0) * group
            st = scratch[:rows * q_pad].view(rows, q_pad)
            product(db_padded[g0 * group:g0 * group + rows], op, st)
            select(st, g0 * group, n_valid, k, group, out_s, out_r, q0, qc)
    return _merge(out_s, out_r, k)


def scores_t_cuda(db_rows, wq, out) -> None:
    """``wt_topk_gemm`` on CUDA tensors (no checks beyond the C entry's:
    called by :func:`group_topk_chunks` from ``fused_topk``)."""
    check(load_library().wt_topk_gemm(
        db_rows.data_ptr(), db_rows.shape[0], db_rows.shape[1],
        wq.data_ptr(), wq.shape[1], out.data_ptr(), _stream(out)),
        "fused_topk (wt_topk_gemm)")


def scores_t_f32_cuda(db_rows, qp, out) -> None:
    """``wt_topk_gemm_f32`` on CUDA tensors, as :func:`scores_t_cuda`: the
    queries qp (Q_pad, D) f32 split by :func:`tf32_split`."""
    qs = tf32_split(qp)
    check(load_library().wt_topk_gemm_f32(
        db_rows.data_ptr(), db_rows.shape[0], db_rows.shape[1],
        qs.data_ptr(), qs.shape[1], qs.shape[2], out.data_ptr(),
        _stream(out)), "fused_topk (wt_topk_gemm_f32)")


_counters: dict = {}


def _counter(name: str, device):
    """The device int the kernels count ``name`` in: a normal tensor even
    when first asked for under ``torch.inference_mode``, so that it may be
    zeroed in either mode."""
    key = torch.device(device)
    if key.type == "cuda" and key.index is None:
        key = torch.device("cuda", torch.cuda.current_device())
    if (name, key) not in _counters:
        with torch.inference_mode(False):
            _counters[name, key] = torch.zeros(1, dtype=torch.int32,
                                               device=key)
    return _counters[name, key]


def overflow_count(device) -> int:
    """The group selection's (query, segment) selections on ``device``
    since the last :func:`reset_overflows` whose survivors overflowed the
    buffer and took the buffer insertion (ties at the lower bound; it
    decides no answer)."""
    return int(_counter("overflows", device).item())


def reset_overflows(device) -> None:
    _counter("overflows", device).zero_()


def flush_count(device) -> int:
    """The threshold scan's query lists on ``device`` since the last
    :func:`reset_flushes` that passed their capacity and were flushed to
    their first k (routine: a flush is how τ rises)."""
    return int(_counter("flushes", device).item())


def reset_flushes(device) -> None:
    _counter("flushes", device).zero_()


def select_groups_cuda(st, row0: int, n_valid: int, k: int, group: int,
                       out_s, out_r, q0: int, qc: int) -> None:
    """``wt_topk_select`` on CUDA tensors, as :func:`scores_t_cuda`."""
    check(load_library().wt_topk_select(
        st.data_ptr(), st.shape[1], st.shape[0], row0, int(n_valid), k,
        group, qc, out_s.data_ptr(), out_r.data_ptr(), out_s.shape[1], q0,
        _counter("overflows", st.device).data_ptr(), _stream(st)),
        "fused_topk (wt_topk_select)")


def scan_tile(qn: int, k: int) -> tuple[int, int]:
    """The threshold scan's query tile and list size for Q = ``qn`` queries
    at ``k``: (qt, p). A CTA scores qt = 1, 8 or 16 queries on one read of
    its rows (the least that holds the batch), each with a list of p
    entries, the k kept and then room for max(k, 32) candidates at the
    least (a warp's survivors always fit after a flush), p a power of two
    >= 128 (the bitonic sort that flushes it). At large k the tile shrinks
    until its lists fit SCAN_LIST_WORDS, which leaves the ring its three
    stages at any D up to MAX_D."""
    p = 128
    while p < k + max(k, 32):
        p *= 2
    qt = 1 if qn <= 1 else 8 if qn <= 8 else SCAN_QUERIES
    while qt > 1 and qt * p > SCAN_LIST_WORDS:
        qt = 8 if qt == SCAN_QUERIES else 1
    return qt, p


def scan_plan(n_pad: int, qn: int, k: int, sms: int) -> tuple[int, int, int]:
    """The threshold scan's launch on ``sms`` SMs: (ranges, qt, p). The
    ceil(Q / qt) query tiles share the SMs, one CTA an SM, and the B =
    ceil(n_pad / SCAN_BLOCK_ROWS) row blocks go evenly to ``ranges`` CTAs a
    tile (range i: blocks [i B / ranges, (i + 1) B / ranges), none empty,
    whatever the group); ``ranges`` is also the candidates' slots."""
    qt, p = scan_tile(qn, k)
    blocks = -(-n_pad // SCAN_BLOCK_ROWS)
    ranges = max(1, min(blocks, sms // -(-qn // qt)))
    return ranges, qt, p


def threshold_scan_cuda(q, db_padded, n_valid: int, k: int, out_s, out_r,
                        top=None) -> None:
    """``wt_topk_threshold`` on CUDA tensors (no checks beyond the C
    entry's: called by ``fused_topk_threshold``): q (Q, D) f32 against the
    rows -> out_s / out_r (ranges, Q, k), ranges from :func:`scan_plan`,
    each range's first k sorted; with ``top`` = (scores (Q, k) f32, rows
    (Q, k) int64), also their first k, merged by the kernel's last CTA of
    each query tile (its tickets are the call's own). Flushes count in
    :func:`flush_count`."""
    qn = q.shape[0]
    qt, p = scan_tile(qn, k)
    top_s, top_r = top if top is not None else (None, None)
    tickets = (torch.empty(-(-qn // qt), dtype=torch.int32, device=q.device)
               if top else None)
    check(load_library().wt_topk_threshold(
        q.data_ptr(), db_padded.data_ptr(),
        int(db_padded.dtype == torch.bfloat16), out_s.data_ptr(),
        out_r.data_ptr(), top_s.data_ptr() if top else None,
        top_r.data_ptr() if top else None,
        tickets.data_ptr() if top else None, qn, q.shape[1],
        db_padded.shape[0], int(n_valid), k, out_s.shape[0], qt, p,
        _counter("flushes", db_padded.device).data_ptr(), _stream(q)),
        "fused_topk_threshold")


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


def order_key(scores, rows):
    """An int64 whose order is (score descending, row ascending) as larger
    first: the score's order-preserving bits (-0 taken as +0) in the high
    word, 2^31 - 1 - row in the low. Built as int32 word pairs viewed as
    int64 (little-endian: the low word first)."""
    bits = (scores.float() + 0.0).view(torch.int32)
    words = torch.empty((*bits.shape, 2), dtype=torch.int32,
                        device=bits.device)
    torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits, out=words[..., 1])
    torch.sub(2 ** 31 - 1, rows, out=words[..., 0])
    return words.view(torch.int64).squeeze(-1)


def _merge(out_s, out_r, k: int):
    """(slots, Q, k) candidates -> the first k by (score descending, row
    ascending): one ``torch.topk`` over :func:`order_key`."""
    qn = out_s.shape[1]
    s = out_s.permute(1, 0, 2).reshape(qn, -1)
    r = out_r.permute(1, 0, 2).reshape(qn, -1)
    _, pos = torch.topk(order_key(s, r), k, dim=1)
    return torch.gather(s, 1, pos), torch.gather(r, 1, pos).long()


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
    if not threshold:
        product = (scores_t_cuda if db_padded.dtype == torch.bfloat16
                   else scores_t_f32_cuda)
        with torch.cuda.device(dev):
            out = group_topk_chunks(q, db_padded, n_valid, k, int(group),
                                    product, select_groups_cuda)
        _launches.add(name, n_pad, d)
        return out
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    qn = q.shape[0]
    ranges = scan_plan(n_pad, qn, k, sms)[0]
    out_s = torch.empty((ranges, qn, k), dtype=torch.float32, device=dev)
    out_r = torch.empty((ranges, qn, k), dtype=torch.int32, device=dev)
    top = (torch.empty((qn, k), dtype=torch.float32, device=dev),
           torch.empty((qn, k), dtype=torch.int64, device=dev))
    with torch.cuda.device(dev):
        threshold_scan_cuda(q, db_padded, n_valid, k, out_s, out_r, top)
    _launches.add(name, n_pad, d)
    return top


def fused_topk_threshold(queries, db_padded, n_valid: int, k: int,
                         group: int = 4096):
    """The running top-k with the threshold skip: each CTA scans a range of
    rows for up to 16 queries at once and keeps only rows that beat its k-th
    entry (:func:`scan_plan`; the module docstring gives the design).
    The served query's kernel (Q = 1, and coalesced batches at small k)."""
    if not db_padded.is_cuda:
        return fused_topk_threshold_plain(queries, db_padded, n_valid, k,
                                          group)
    return _launch("fused_topk_threshold", queries, db_padded, n_valid, k,
                   group, threshold=True)


def fused_topk(queries, db_padded, n_valid: int, k: int, group: int = 4096):
    """Each group's own top-k, then the merge. The batched search's kernel.
    Exact for k <= group. Either storage type: the product kernel writes Sᵀ
    for up to 64 queries at a time (bf16: the GEMM; f32: three TF32
    products) and the selection kernel keeps each group's top-k
    (:func:`group_topk_chunks`; the module docstring gives the bound)."""
    if not db_padded.is_cuda:
        return fused_topk_plain(queries, db_padded, n_valid, k, group)
    return _launch("fused_topk", queries, db_padded, n_valid, k, group,
                   threshold=False)
